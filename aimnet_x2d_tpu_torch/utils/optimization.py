"""Parameter freezing, counting and layer-wise LR decay by parameter name
(counterpart of aimnet_x2d_tpu/utils/optimization.py and the decay of
aimnet_x2d_tpu/training/trainer.py::make_optimizer).

Patterns and depths are taken from the parameter's flat flax name
(``params/message_passing_layers_0/input_proj_kernel``), not torch's dotted
name, so one ``--freeze_layers`` list selects the same tensors in both
packages.  Freezing is a 0/1 factor on the optimizer's update (the trainer
keeps every gradient, so the global-norm clip sees the frozen ones too, as
under optax).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from ..checkpoint import param_specs, torch_name


def flax_names(model: nn.Module) -> Dict[str, str]:
    """torch parameter name -> flat flax name, for every parameter of a GNN
    (from the config's parameter list; no arrays are made)."""
    return {torch_name(k)[0]: k for k in param_specs(model.config)}


def freeze_mask(model: nn.Module, patterns: Sequence[str], freeze: bool = True) -> Dict[str, float]:
    """torch parameter name -> 0.0 or 1.0: 0 for parameters whose flax name
    contains any pattern (``freeze``), or 1 only for those (``freeze=False``,
    train-only-these)."""
    out = {}
    for name, key in flax_names(model).items():
        hit = any(p in key for p in patterns)
        out[name] = 1.0 if (not hit if freeze else hit) else 0.0
    return out


def train_mask(model: nn.Module, freeze_patterns: Optional[Sequence[str]],
               unfreeze_patterns: Optional[Sequence[str]]) -> Optional[Dict[str, float]]:
    """The trainer's mask: unfreeze patterns win over freeze patterns, as in
    the JAX ``make_optimizer``; None when neither is given."""
    if unfreeze_patterns:
        return freeze_mask(model, unfreeze_patterns, freeze=False)
    if freeze_patterns:
        return freeze_mask(model, freeze_patterns, freeze=True)
    return None


def lr_decay_scales(model: nn.Module, factor: float) -> Dict[str, float]:
    """torch parameter name -> ``factor ** depth``, depth the number of
    ``/`` in the flax name (``params/output_layer/kernel`` -> 2)."""
    return {name: factor ** key.count("/") for name, key in flax_names(model).items()}


def count_parameters(model: nn.Module, mask: Optional[Dict[str, float]] = None) -> Dict[str, int]:
    """Total and trainable parameter counts; parameters with mask 0 are not
    trainable, and without a mask all are."""
    total = trainable = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if mask is None or mask[name]:
            trainable += p.numel()
    return {"total_parameters": total, "trainable_parameters": trainable}
