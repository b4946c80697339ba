"""SMILES parsing and featurization: a copy of the JAX package's pure-Python
featurizer (``aimnet_x2d_tpu/chem``), so the port depends on nothing there."""

from .featurize import compute_features, parse_atomic_numbers
from .smiles import Molecule, parse_smiles

__all__ = ["compute_features", "parse_atomic_numbers", "Molecule", "parse_smiles"]
