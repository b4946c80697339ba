"""Random hyperparameter search over a YAML space (counterpart of
aimnet_x2d_tpu/hyperopt.py; the same sampler, draw for draw, and the same
trial records).

A space maps CLI flag names to specs:
  param: [a, b, c]                                  -> uniform choice
  param: {type: int, min: 2, max: 8}                -> uniform integer
  param: {type: float, min: .., max: .., log: true} -> (log-)uniform float
  param: {type: choice, values: [...]}              -> uniform choice
  param: value                                      -> constant

Trial t copies the base arguments, applies its sample, re-derives the
fields derived from a sampled source (``ffn_hidden_dim`` from
``hidden_dim`` and so on), runs the whole training run
(``runner.main_runner``) with seed ``seed + t`` into
``<model>.trial<t>`` (under ``--iterable_dataset`` with HDF5 files of its
own in a temporary directory, removed after: featurization depends on the
sampled ``num_shells``), and records its validation loss.  A trial that
raises is recorded as ``"status": "failed"`` with its error, and the
search goes on.  The best trial's artifact is saved to the base path,
checked by reloading, the trial artifacts are removed, and every trial's
record goes to ``<model>.hyperopt_results.json``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import shutil
import tempfile
import time
from typing import Any, Dict, List


def sample_hparam_value(rng: random.Random, spec: Any) -> Any:
    """One draw of ``spec`` (module docstring) from ``rng``."""
    if isinstance(spec, list):
        return rng.choice(spec)
    if isinstance(spec, dict):
        t = spec.get("type")
        if t == "int":
            return rng.randint(int(spec["min"]), int(spec["max"]))
        if t == "float":
            lo, hi = float(spec["min"]), float(spec["max"])
            if spec.get("log"):
                return math.exp(rng.uniform(math.log(lo), math.log(hi)))
            return rng.uniform(lo, hi)
        if t == "choice":
            return rng.choice(spec["values"])
        raise ValueError(f"Unknown hyperparameter spec type: {t}")
    return spec


def sample_trials(space: Dict[str, Any], seed: int, num_trials: int) -> List[Dict[str, Any]]:
    """The configurations a search with ``seed`` samples, in trial order."""
    rng = random.Random(seed)
    return [{k: sample_hparam_value(rng, v) for k, v in space.items()} for _ in range(num_trials)]


def trial_arguments(args, sampled: Dict[str, Any], trial: int):
    """Trial ``trial``'s arguments: the base ``args`` with ``sampled``
    applied, derived fields re-derived, seed and artifact path its own."""
    from .cli import postprocess_arguments

    trial_args = copy.deepcopy(args)
    for k, v in sampled.items():
        setattr(trial_args, k, v)
    # postprocess_arguments fills these only when None, and the base
    # arguments were postprocessed once already
    for derived, source in (("ffn_hidden_dim", "hidden_dim"),
                            ("precompute_num_workers", "num_workers"),
                            ("stream_batch_size", "batch_size")):
        if source in sampled and derived not in sampled:
            setattr(trial_args, derived, None)
    trial_args.hyperparameter_file = None
    trial_args.num_trials = 1
    trial_args.seed = args.seed + trial
    trial_args.model_save_path = args.model_save_path + f".trial{trial}"
    return postprocess_arguments(trial_args)


def run_hyperparameter_optimization(args) -> Dict[str, Any]:
    """Run the search ``args.hyperparameter_file`` describes (module
    docstring); returns ``{"results": [...], "best": {...}}``."""
    import yaml

    from .checkpoint import load_artifact, save_artifact
    from .runner import main_runner

    with open(args.hyperparameter_file) as f:
        space: Dict[str, Any] = yaml.safe_load(f)

    results: List[Dict[str, Any]] = []
    best = {"val_loss": float("inf"), "trial": -1, "config": None, "summary": None}
    for trial, sampled in enumerate(sample_trials(space, args.seed, args.num_trials)):
        trial_args = trial_arguments(args, sampled, trial)
        tmp_dir = None
        if trial_args.iterable_dataset:
            tmp_dir = tempfile.mkdtemp(prefix=f"aimnet_hyperopt_trial{trial}_")
            for attr in ("train_hdf5", "val_hdf5", "test_hdf5"):
                base = os.path.basename(getattr(trial_args, attr) or f"{attr}.h5")
                setattr(trial_args, attr, os.path.join(tmp_dir, base))

        print(f"\n===== trial {trial + 1}/{args.num_trials}: {sampled} =====")
        t0 = time.time()
        try:
            summary = main_runner(trial_args)
            val_loss = summary["best_val_loss"]
        except Exception as e:
            print(f"[trial {trial}] FAILED: {type(e).__name__}: {e}")
            results.append({"trial": trial, "config": sampled, "status": "failed",
                            "error": str(e)})
            continue
        finally:
            if tmp_dir is not None:
                shutil.rmtree(tmp_dir, ignore_errors=True)
        results.append({
            "trial": trial,
            "config": sampled,
            "status": "ok",
            "val_loss": val_loss,
            "test_metrics": {k: v for k, v in summary["test_metrics"].items()
                             if not isinstance(v, dict)},
            "seconds": time.time() - t0,
        })
        if val_loss < best["val_loss"]:
            best = {"val_loss": val_loss, "trial": trial, "config": sampled,
                    "artifact": trial_args.model_save_path}

    if best["trial"] >= 0:
        art = load_artifact(best["artifact"])
        save_artifact(args.model_save_path, art.params, art.model_config, art.pipeline,
                      extra={**art.extra, "hyperopt_best_trial": best["trial"],
                             "hyperopt_config": best["config"]})
        reloaded = load_artifact(args.model_save_path)
        if reloaded.model_config != art.model_config:
            raise RuntimeError("the promoted artifact does not reload to its configuration")
        print(f"\n[hyperopt] best trial {best['trial']} (val_loss {best['val_loss']:.5f}) -> "
              f"{args.model_save_path}")
        for r in results:
            p = args.model_save_path + f".trial{r['trial']}"
            for cand in (p, p + ".npz"):
                if os.path.exists(cand):
                    os.remove(cand)

    out_path = args.model_save_path + ".hyperopt_results.json"
    with open(out_path, "w") as f:
        json.dump({"results": results, "best": dict(best)}, f, indent=2, default=str)
    print(f"[hyperopt] results -> {out_path}")
    return {"results": results, "best": best}
