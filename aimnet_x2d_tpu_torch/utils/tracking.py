"""Optional Weights & Biases tracking with a no-op fallback (counterpart of
aimnet_x2d_tpu/utils/tracking.py): run init, per-epoch scalars, a final
summary.  When ``--enable_wandb`` is set and wandb is not installed, the
run goes on untracked after a warning."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence


class Tracker:
    """No-op tracker."""

    enabled = False

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def summary(self, metrics: Dict[str, Any]) -> None:
        pass

    def finish(self) -> None:
        pass


class WandbTracker(Tracker):
    enabled = True

    def __init__(self, project: str, entity: Optional[str], config: Dict[str, Any],
                 tags: Optional[Sequence[str]] = None):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=project, entity=entity, config=config,
                              tags=list(tags) if tags else None)

    def log(self, metrics, step=None):
        self._wandb.log(metrics, step=step)

    def summary(self, metrics):
        for k, v in metrics.items():
            self.run.summary[k] = v

    def finish(self):
        self._wandb.finish()


def create_tracker(args) -> Tracker:
    if not getattr(args, "enable_wandb", False):
        return Tracker()
    try:
        return WandbTracker(
            project=args.wandb_project,
            entity=args.wandb_entity,
            config={k: v for k, v in vars(args).items() if not k.startswith("_")},
            tags=args.wandb_tag_list,
        )
    except ImportError:
        print("[warning] --enable_wandb set but wandb is not installed; tracking disabled")
        return Tracker()
