"""Training loop (counterpart of aimnet_x2d_tpu/training/trainer.py).

One train step is: the training forward (``GNN.forward(train=True)``,
dropout on) -> loss on the real molecules -> backward through the kernels'
autograd functions -> global-norm clip -> Adam -> parameters updated in
place, as the JAX step's ``value_and_grad -> optax.clip_by_global_norm ->
optax.scale_by_adam -> scale(-lr)``:

- the clip is optax's: when the global norm exceeds ``grad_clip`` every
  gradient is scaled by ``grad_clip / norm``, and nothing changes otherwise
  (``torch.nn.utils.clip_grad_norm_`` differs: it always rescales, by
  ``max / (norm + 1e-6)``);
- Adam is optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 added
  after the square root, both moments bias-corrected), and the learning
  rate is applied as data, so the host-side schedulers change it freely;
- freeze masks and layer-wise LR decay come after Adam, in optax's chain
  order: the 0/1 mask of ``freeze_patterns`` / ``unfreeze_patterns``, then
  ``lr_decay_factor ** depth`` (``utils/optimization.py``), then ``-lr``.
  Frozen parameters keep their gradients, so the global-norm clip and the
  Adam moments see them as under optax, and only their update is zero.

``train`` runs the epochs: shuffled training batches (a new order every
epoch) fed through :func:`prefetch_batches` (collate and copy in two
threads, the copies on a stream of their own on the card), validation, the
LR scheduler, early stopping, a copy of the best parameters, restored at the
end, an optional tracker, and periodic checkpoints that a later run resumes
from.

Over a (data, graph) rank grid (``grid``, parallel/mesh.py; the CLI's
``--num_devices`` / ``--graph_shards``) each rank runs this loop on its own
shard with the grid's step (``train_step(grid=)``, the rule in
parallel/graph_parallel.py): dropout generators seeded per data rank, the
epoch's loss and edge count the grid's, rank 0 alone printing, tracking
and checkpointing, and the validation metrics rank 0's
(``evaluate(grid=)``), so the scheduler, early stopping and the best
parameters decide the same on every rank.  The edges/s meter counts each
step's edges: the binned adjacency's multiplicities plus ``halo_adj``'s on a
halo shard, the real edge slots otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import MolBatch
from ..models.gnn import GNN
from ..models.losses import create_loss_function
from ..parallel.graph_parallel import allreduce_grads, grid_objective
from ..utils.optimization import lr_decay_scales, train_mask
from .evaluator import evaluate
from .schedulers import create_scheduler


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    learning_rate: float = 0.00025
    loss_function: str = "l1"
    task_type: str = "regression"
    multitask_weights: Optional[Sequence[float]] = None
    evidential_lambda: float = 1.0
    grad_clip: float = 1.0
    early_stopping: bool = False
    patience: int = 25
    lr_scheduler: str = "ReduceLROnPlateau"
    lr_reduce_factor: float = 0.5
    lr_patience: int = 10
    lr_cosine_t_max: int = 10
    lr_step_size: int = 10
    lr_step_gamma: float = 0.1
    lr_exp_gamma: float = 0.95
    layer_wise_lr_decay: bool = False
    lr_decay_factor: float = 0.8
    freeze_patterns: Optional[Sequence[str]] = None  # freeze matching parameters
    unfreeze_patterns: Optional[Sequence[str]] = None  # train only matching ones


@dataclasses.dataclass
class TrainResult:
    state_dict: Dict[str, torch.Tensor]  # the best epoch's parameters (a copy)
    best_val_loss: float
    best_epoch: int
    history: List[Dict[str, float]]
    avg_epoch_seconds: float


class Optimizer:
    """Global-norm clip, then Adam, then an optional per-parameter factor
    (``scales``: the freeze mask times the layer-wise decay), with optax's
    arithmetic (see the module docstring).  ``step(lr)`` updates every
    parameter that has a gradient; a parameter that never gets one (the
    dead parameters kept for checkpoint parity) keeps zero moments and
    never moves, as under optax."""

    def __init__(self, params: Sequence[torch.nn.Parameter], grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 scales: Optional[Sequence[float]] = None):
        self.params = list(params)
        self.grad_clip, self.b1, self.b2, self.eps = grad_clip, b1, b2, eps
        self.scales = None if scales is None else [float(s) for s in scales]
        if self.scales is not None and len(self.scales) != len(self.params):
            raise ValueError(f"{len(self.scales)} scales for {len(self.params)} parameters")
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(saved) != len(mine):
                raise ValueError(f"optimizer state of {len(saved)} tensors, {len(mine)} expected")
            for t, s in zip(mine, saved):
                t.copy_(s)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.clip_by_global_norm in place; returns the global norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip is not None:
            # g * (max / norm) where norm >= max, else g exactly; no host sync
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        return norm

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        grads = [self.params[i].grad for i in live]
        mu = [self.mu[i] for i in live]
        nu = [self.nu[i] for i in live]
        norm = self.clip(grads)
        self.count += 1
        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - self.b2))
        c1 = float(1.0 - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(1.0 - np.float32(self.b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.scales is not None:
            torch._foreach_mul_(upd, [self.scales[i] for i in live])
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return norm


def make_optimizer(model: GNN, config: TrainConfig) -> Optimizer:
    """The optimizer of ``config`` over ``model.parameters()`` (the JAX
    ``make_optimizer``): a freeze mask when freeze or unfreeze patterns are
    given, times the layer-wise decay when it is on."""
    named = list(model.named_parameters())
    mask = train_mask(model, config.freeze_patterns, config.unfreeze_patterns)
    decay = lr_decay_scales(model, config.lr_decay_factor) if config.layer_wise_lr_decay else None
    scales = None
    if mask is not None or decay is not None:
        scales = [(1.0 if mask is None else mask[n]) * (1.0 if decay is None else decay[n])
                  for n, _ in named]
    return Optimizer([p for _, p in named], config.grad_clip, scales=scales)


def make_loss_fn(config: TrainConfig) -> Callable:
    return create_loss_function(config.loss_function, config.task_type, config.multitask_weights,
                                lambda_reg=config.evidential_lambda)


def train_step(model: GNN, optimizer: Optimizer, batch: MolBatch, lr: float, loss_fn: Callable,
               drop_seed: Optional[int] = None, generator: Optional[torch.Generator] = None,
               grid=None):
    """One step on a batch already on the model's device.  Returns the loss
    and the real molecules it averages over, 0-d tensors still on the
    device (reading them syncs).  With ``grid`` (parallel/mesh.py) the batch
    is this rank's shard: the loss is the weighted mean over the data ranks,
    this rank backprops its share of it and the gradients are summed over
    every rank before the update (parallel/graph_parallel.py)."""
    optimizer.zero_grad()
    out = model(batch, train=True, drop_seed=drop_seed, generator=generator)
    loss = loss_fn(out.predictions, batch.targets, batch.graph_mask)
    n = batch.graph_mask.sum().float()
    if grid is None:
        loss.backward()
        loss = loss.detach()
    else:
        objective, loss, n = grid_objective(loss, n, grid)
        objective.backward()
        allreduce_grads(optimizer.params, grid)
    optimizer.step(lr)
    return loss, n


# seed offset of data rank d's dropout generators (graph ranks share them)
DATA_SEED_STRIDE = 1_000_003


def batch_edges(batch: MolBatch) -> int:
    """Real edges of a host batch (the edges/s meter's count)."""
    if batch.halo_adj is not None:
        return int(batch.bin_adj.sum(dtype=np.int64)) + int(batch.halo_adj.sum(dtype=np.int64))
    return int(np.count_nonzero(batch.edge_mask))


def prefetch_batches(loader, device: "str | torch.device", size: int = 2,
                     stats: Optional[Dict[str, float]] = None):
    """Two-stage background prefetch (the JAX ``prefetch_batches``): one
    thread collates (iterates ``loader``), a second copies each batch to
    ``device``, with queues of ``size`` between them and the caller, so a
    step costs max(collate, copy, step) instead of their sum.  Yields
    ``(device_batch, real_edges)`` in the loader's order, the edge count
    (:func:`batch_edges`) taken in the collate thread.  An error in either
    thread is raised here; the transfer thread drains the collate queue up
    to its end, so a failed copy cannot leave the collate thread blocked on
    a full queue.

    On the card the copies are asynchronous: each host array is first put in
    pinned memory (the native builder's pinned scratch as it is, anything
    else by a pinned staging copy), then copied with ``non_blocking`` on a
    CUDA stream of its own; an event recorded after a batch's copies is waited
    on by the transfer thread before it queues the batch (so the loader may
    rebuild those host buffers once the batch is queued) and by the
    consumer's stream before the step reads it; each device tensor is
    ``record_stream``-ed on the consumer's stream, so the caching allocator
    does not hand its memory to a later copy while the step still reads it.
    There is no fallback: a failure to pin or to copy fails the run.  On the
    CPU the same threads and queues run, with plain copies.

    With ``stats`` (a dict) the consumer's waits on the device queue
    (``wait_s``, host clock), the copy stream's time from a batch's first
    copy to its last (``copy_ms``, CUDA events, on the card) and the
    batches (``batches``) are added to it.

    In flight at once: 1 batch being built, ``size`` queued for transfer, 1
    in transfer, ``size`` queued here and 1 in the step; a loader that
    rotates ``SCRATCH_SETS`` scratch sets must cover them, so a deeper
    pipeline raises ValueError."""
    import queue
    import threading

    from ..data.native_batch import SCRATCH_SETS

    if 2 * size + 3 > SCRATCH_SETS:
        raise ValueError(f"prefetch size={size} can hold {2 * size + 3} batches in flight but "
                         f"loaders rotate only {SCRATCH_SETS} scratch sets "
                         "(aimnet_x2d_tpu_torch/data/native_batch.py::SCRATCH_SETS): raise "
                         "SCRATCH_SETS or lower the prefetch size")
    device = torch.device(device)
    cuda = device.type == "cuda"
    stats = {} if stats is None else stats
    for k in ("wait_s", "copy_ms", "batches"):
        stats.setdefault(k, 0.0)
    if cuda:
        copy_stream = torch.cuda.Stream(device)
        consumer = torch.cuda.current_stream(device)

        def pin(t: torch.Tensor) -> torch.Tensor:
            return t if t.is_pinned() else t.pin_memory()

        def copy(t: torch.Tensor) -> torch.Tensor:
            out = t.to(device, non_blocking=True)
            out.record_stream(consumer)
            return out

    q_host: "queue.Queue" = queue.Queue(maxsize=size)
    q_dev: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    errors: List[BaseException] = []

    def collate_worker():
        try:
            for batch in loader:
                if errors:  # the transfer failed; its drain keeps q_host moving
                    break
                q_host.put((batch, batch_edges(batch)))
        except BaseException as e:  # raised in the consumer
            errors.append(e)
        finally:
            q_host.put(sentinel)

    def transfer(batch: MolBatch):
        if not cuda:
            return batch.to(device), None
        staged = batch.to("cpu", pin)  # every array in pinned memory first
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(copy_stream)
            moved = staged.to(device, copy)
            done.record(copy_stream)
        done.synchronize()
        stats["copy_ms"] += start.elapsed_time(done)
        return moved, done

    def transfer_worker():
        saw_sentinel = False
        try:
            while True:
                item = q_host.get()
                if item is sentinel:
                    saw_sentinel = True
                    break
                if errors:
                    break
                batch, edges = item
                q_dev.put((*transfer(batch), edges))
        except BaseException as e:
            errors.append(e)
        finally:
            while not saw_sentinel:  # unblock the collate thread, then end
                if q_host.get() is sentinel:
                    saw_sentinel = True
            q_dev.put(sentinel)

    threads = [threading.Thread(target=collate_worker, daemon=True),
               threading.Thread(target=transfer_worker, daemon=True)]
    for t in threads:
        t.start()
    ended = False
    try:
        while True:
            t0 = time.perf_counter()
            item = q_dev.get()
            stats["wait_s"] += time.perf_counter() - t0
            if item is sentinel:
                ended = True
                break
            batch, ready, edges = item
            if ready is not None:
                consumer.wait_event(ready)
            stats["batches"] += 1
            yield batch, edges
    finally:
        if not ended:
            # the consumer stopped early: tell the workers, drain, let them end
            errors.append(StopIteration())
            while q_dev.get() is not sentinel:
                pass
        for t in threads:
            t.join()
    if errors and ended:
        raise errors[0]


def train(
    model: GNN,
    train_loader,
    val_loader,
    config: TrainConfig,
    *,
    device: "str | torch.device" = "cuda",
    seed: int = 0,
    pipeline=None,
    tracker=None,
    checkpointer=None,
    checkpoint_every: int = 10,
    grid=None,
) -> TrainResult:
    """Epoch loop with validation, LR scheduling, early stopping and
    best-parameter restore.  ``model`` is on ``device``; ``seed`` seeds the
    dropout generators (the stack's per-step seed is drawn on the host, the
    FFN's masks on the device).

    ``tracker`` (``utils/tracking.py``) gets each epoch's record.  With a
    ``checkpointer`` (``checkpoint.TrainCheckpointer``) the state is saved
    after every ``checkpoint_every``-th epoch, and a run whose checkpoint
    directory holds one resumes after its epoch: parameters, Adam moments
    and step count, LR, scheduler state, early-stop counters and the
    best-so-far parameters are restored.  The dropout generators start
    again from ``seed``, as the JAX package's dropout key does.

    With ``grid`` (this rank's place in the rank grid) the loaders yield this
    rank's shards and each step is the grid's (:func:`train_step` with
    ``grid``; the JAX ``train(train_step=)``; see the module docstring)."""
    device = torch.device(device)
    optimizer = make_optimizer(model, config)
    loss_fn = make_loss_fn(config)
    primary = grid is None or grid.rank == 0
    if grid is not None:
        seed += DATA_SEED_STRIDE * grid.data.index
    scheduler = create_scheduler(
        config.lr_scheduler, config.learning_rate,
        lr_reduce_factor=config.lr_reduce_factor, lr_patience=config.lr_patience,
        lr_cosine_t_max=config.lr_cosine_t_max, lr_step_size=config.lr_step_size,
        lr_step_gamma=config.lr_step_gamma, lr_exp_gamma=config.lr_exp_gamma,
    )
    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    best_val, best_epoch = float("inf"), -1
    best_state = None
    epochs_no_improve = 0
    if device.type == "cuda" and hasattr(train_loader, "rotate_scratch"):
        # the prefetch copies each batch off the host before SCRATCH_SETS
        # more are built, so the native builder may recycle pinned buffers
        train_loader.rotate_scratch()
    history: List[Dict[str, Any]] = []
    lr = config.learning_rate
    epoch_times: List[float] = []

    start_epoch = 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        last, params, opt_state, aux, best_state = restored
        model.load_state_dict(params)
        optimizer.load_state_dict(opt_state)
        start_epoch = last + 1
        lr = aux.get("lr", lr)
        best_val = aux.get("best_val", best_val)
        best_epoch = int(aux.get("best_epoch", best_epoch))
        epochs_no_improve = int(aux.get("epochs_no_improve", 0))
        scheduler.load_state_dict(
            {k[len("sched_"):]: v for k, v in aux.items() if k.startswith("sched_")})
        if primary:
            print(f"[resume] restored checkpoint at epoch {last}", flush=True)
    if best_state is None:
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    else:
        best_state = {k: v.to(device) for k, v in best_state.items()}

    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        train_loader.set_epoch(epoch)
        model.train()
        losses, counts = [], []
        edges = 0
        feed: Dict[str, float] = {}
        for batch, batch_e in prefetch_batches(train_loader, device, stats=feed):
            edges += batch_e
            drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=host_gen))
            loss, n = train_step(model, optimizer, batch, lr, loss_fn, drop_seed, dev_gen, grid)
            losses.append(loss)
            counts.append(n)
        # one read per epoch, not one sync per step
        step_losses = torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0)
        step_counts = torch.stack(counts).float().cpu().numpy() if counts else np.zeros(0)
        train_loss = float((step_losses * step_counts).sum() / max(step_counts.sum(), 1))
        if grid is not None:
            edges = int(grid.world.all_reduce(torch.tensor(float(edges), dtype=torch.float64,
                                                           device=device)))
        train_seconds = time.time() - t0
        model.eval()
        val_metrics = evaluate(model, val_loader, device, loss_fn=loss_fn, pipeline=pipeline,
                               grid=grid)
        val_loss = val_metrics["loss"]
        lr = scheduler.step(epoch, val_loss)
        seconds = time.time() - t0
        epoch_times.append(seconds)
        record = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss, "lr": lr,
                  "seconds": seconds, "edges_per_sec": edges / max(train_seconds, 1e-9),
                  "train_seconds": train_seconds, "steps": len(losses),
                  "input_wait_seconds": feed["wait_s"], "copy_ms": feed["copy_ms"],
                  **{f"val_{k}": v for k, v in val_metrics.items()
                     if k != "loss" and not isinstance(v, dict)}}
        history.append(record)
        if tracker is not None and primary:
            tracker.log(record, step=epoch)
        if primary:
            print(f"[epoch {epoch:3d}] train {train_loss:.5f}  val {val_loss:.5f}  "
                  f"lr {lr:.2e}  ({seconds:.1f}s, {record['edges_per_sec'] / 1e6:.2f}M edges/s)",
                  flush=True)
        if val_loss < best_val:
            best_val, best_epoch = val_loss, epoch
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1
        if checkpointer is not None and primary and (epoch + 1) % checkpoint_every == 0:
            aux = {"lr": float(lr), "best_val": float(best_val), "best_epoch": float(best_epoch),
                   "epochs_no_improve": float(epochs_no_improve),
                   **{f"sched_{k}": v for k, v in scheduler.state_dict().items()}}
            checkpointer.save(epoch, model.state_dict(), optimizer.state_dict(), aux,
                              best_params=best_state)
        if config.early_stopping and epochs_no_improve >= config.patience and val_loss >= best_val:
            if primary:
                print(f"[early stop] epoch {epoch}, best {best_val:.5f} @ {best_epoch}")
            break

    model.load_state_dict(best_state)
    return TrainResult(
        state_dict=best_state,
        best_val_loss=best_val,
        best_epoch=best_epoch,
        history=history,
        avg_epoch_seconds=float(np.mean(epoch_times)) if epoch_times else 0.0,
    )
