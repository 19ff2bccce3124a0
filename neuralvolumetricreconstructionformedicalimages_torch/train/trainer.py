"""Training loop: the epoch function + the reference-shaped orchestrator.

Port of the JAX ``train/trainer.py``:

- ``make_epoch_fn``: one optimizer step per sampled view batch over an
  epoch.  The JAX package jits the epoch as one ``lax.scan``; on the card
  the port captures one step as a CUDA graph and replays it for every
  step, with no host sync between the steps -- the host touches the
  device once per epoch to upload the view order, and reads the losses
  back once, at its end;
- Adam(0.9, 0.999) with the StepLR schedule in optimizer-step units;
- beam-masked MSE (or any ``train.loss`` of ``losses.get_loss_fn``);
- checkpoints with ``torch.save`` (newest two kept) and resume;
- eval at epoch 0, every ``i_eval`` epochs and at the end: one val view
  rendered in full, the voxel grid queried, projection MSE/PSNR and 3D
  PSNR/SSIM, slice mosaics and npy/png/stats.txt artifacts;
- with ``parallel.mesh`` larger than one device (or ``parallel.force_mesh``)
  the sharded epoch function of ``parallel/step.py`` over the ranks of the
  process group (captured and replayed like ``make_epoch_fn``'s under
  NCCL, eager under gloo): rank 0 alone evaluates, logs and saves, and
  every rank restores the same checkpoint.

The trainer runs on the card unless it is given ``device="cpu"``; without
a card it raises.
"""

from __future__ import annotations

import contextlib
import datetime
import glob
import json
import os
import os.path as osp
import re
import struct
import time
import zlib
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import with_defaults
from ..data.dataset import gather_batch, load_dataset
from ..losses import get_loss_fn, global_sum
from ..metrics import cast_to_image, get_mse, get_psnr, get_psnr_3d, get_ssim_3d
from ..models import DensityField, get_encoder, get_network
from ..ops import _build
from ..render import query_field, render_image, render_rays
from ..utils.logging import ExperimentLogger
from ..utils import profiling
from ..utils.profiling import StepTimer, layer_range, range_mark
from .optim import make_lr_schedule, make_optimizer, set_lr


# --------------------------------------------------------------------------
# Functional core
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a missing card raises (no CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def pin_fp32() -> None:
    """Full-precision float32 contractions (no TF32), as the JAX package's
    ``precision="highest"``: reduced precision moves ray origins by
    detector pixels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(cfg: Dict[str, Any], generator: Optional[torch.Generator] = None,
                device="cpu") -> DensityField:
    """Field (encoder + MLP) from the config schema; ``parallel`` supplies
    the precision policy (``table_dtype``, ``compute_dtype``)."""
    par = cfg.get("parallel", {})
    enc_cfg = dict(cfg["encoder"])
    enc_cfg.setdefault("table_dtype", par.get("table_dtype", "float32"))
    enc = get_encoder(**enc_cfg)
    net_cfg = dict(cfg["network"])
    net_type = net_cfg.pop("net_type", "mlp")
    net_cfg["skips"] = tuple(net_cfg.get("skips", (4,)))
    net_cfg.setdefault("compute_dtype", par.get("compute_dtype", "float32"))
    return get_network(net_type)(encoder=enc, generator=generator,
                                 device=device, **net_cfg)


def make_loss_fn(cfg: Dict[str, Any], use_mask: bool, group=None):
    """``loss_fn(field, field_fine, batch, generator=None, t_rand=None,
    noise=None)``: render the batch's rays and reduce them to the training
    loss.  With a process ``group`` (the sharded step's data group) the
    loss is that of the group's concatenated batch, and the TV terms are
    the sum (``tv_loss``) and the mean (``tv_density``) over its ranks."""
    render_cfg = cfg["render"]
    n_samples = int(render_cfg["n_samples"])
    n_fine = int(render_cfg["n_fine"])
    perturb = bool(render_cfg["perturb"])
    raw_noise_std = float(render_cfg["raw_noise_std"])
    loss_name = str(cfg["train"].get("loss", "mse"))
    loss_calc = get_loss_fn(loss_name, group=group)
    # the TV terms are reduced over the group only when the loss reads them
    uses_tv = any(r.split(":")[0].strip().lower() in ("tv", "tvd")
                  for r in loss_name.split("+")[1:])

    def loss_fn(field, field_fine, batch, generator=None, t_rand=None, noise=None):
        out = render_rays(
            batch["rays"], field, n_samples=n_samples, n_fine=n_fine,
            perturb=perturb, raw_noise_std=raw_noise_std, generator=generator,
            field_fine=field_fine, t_rand=t_rand, noise=noise)
        with layer_range("loss"):
            mask = batch["mask"] if use_mask else None
            aux = {"tv_loss": out["tv_loss"], "tv_density": out["tv_density"]}
            if group is not None and uses_tv:
                aux = {"tv_loss": global_sum(aux["tv_loss"], group),
                       "tv_density": global_sum(aux["tv_density"], group)
                       / dist.get_world_size(group)}
            loss, _ = loss_calc(out["acc"], batch["projs"], mask, aux)
            if n_fine > 0 and field_fine is not None:
                # regularizers count once, on the fine loss
                loss0, _ = loss_calc(out["acc0"], batch["projs"], mask)
                loss = loss + loss0
            return loss

    return loss_fn


# The draws a step can be fed in place of its generator's (tests feed the
# JAX package's): the pool draw [n_batch, n_rays], the stratified jitter
# [n_batch * n_rays, n_samples] and the raw noise of the coarse pass.
DRAWS = ("r", "t_rand", "noise")


def make_train_step(cfg: Dict[str, Any], field: DensityField, optimizer, *,
                    n_rays: int, n_batch: int, use_mask: bool,
                    generator: Optional[torch.Generator],
                    field_fine: Optional[DensityField] = None,
                    geo=None, near: float = 0.0, far: float = 0.0) -> Callable:
    """One optimizer step: ``step(arrays, views, *, r=None, t_rand=None,
    noise=None) -> loss`` (on the device, detached).

    ``views`` ([n_batch] int64 on the arrays' device): ``n_rays`` pixels of
    each (``gather_batch``), rendered and reduced to the loss, whose
    gradient ``optimizer`` applies at its current rate (``set_lr``).  The
    draws come from ``generator`` unless fed (:data:`DRAWS`).  Every op
    runs on the device without a host sync, so that the step can be
    captured in a CUDA graph; ``geo``/``near``/``far`` enable the
    on-the-fly ray mode (see data/dataset.py).  Its layer ranges
    (``utils/profiling.py``) tile it: ``batch``, ``sample``, the encoder's,
    ``mlp``, ``render``, ``loss``, the backward's marks, ``optim``.
    """
    loss_fn = make_loss_fn(cfg, use_mask)

    def step(arrays, views, *, r=None, t_rand=None, noise=None):
        if tuple(views.shape) != (n_batch,):
            raise ValueError(f"views of shape {tuple(views.shape)}, the step "
                             f"takes [{n_batch}]")
        batch = gather_batch(arrays, views, n_rays, generator, r=r, geo=geo,
                             near=near, far=far)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(field, field_fine, batch, generator, t_rand=t_rand,
                       noise=noise)
        with layer_range("backward"):
            range_mark("backward.render")
            loss.backward()
        with layer_range("optim"):
            optimizer.step()
            return loss.detach()

    return step


class _GraphedStep:
    """A training step captured once as a CUDA graph and replayed.

    The first call (and the first after the graph's key changed: an input's
    shape, or a tensor the graph reads that moved) runs the step eagerly on
    the capture stream -- it warms the allocator, cuBLAS on that stream,
    Adam's state and any NCCL communicator the step uses -- and then
    captures it, with ``generators`` (one, a sequence, or None) registered
    so that every replay draws on from where the last left off.  Every
    later call copies its inputs into the graph's buffers and replays it.

    With ``twin`` (the default), a second graph is captured right after the
    first, with no eager step of its own: the same step with its range
    marks (``utils/profiling.py``), the marked twin.  A call replays the
    twin in place of the plain graph while a profiler runs or inside a
    ``profiling.ranges()`` block (the plain graph carries no mark), and
    zeroes the range sums when it switches from plain to marked replays.
    The twin registers the same generators, so both draw from one sequence,
    and it shares the plain graph's memory pool, so the peak stays the
    same.  Sharing is safe because a replay's outputs are consumed before
    the other graph replays: a call returns the loss buffer of the graph it
    replayed, which the caller copies out in stream order, and the
    gradients live only within a replay, where its own Adam reads them.
    Nothing outside the step may read a parameter's ``.grad`` between
    replays: it holds the buffer of the graph captured last.

    A capture adds nothing to ``_build.LAUNCHES``; each replay adds the
    launches its graph's capture recorded.  A capture that fails raises:
    nothing drops back to eager steps.
    """

    def __init__(self, step: Callable, optimizer, generators, twin: bool = True):
        self.step = step
        self.optimizer = optimizer
        if not isinstance(generators, (list, tuple)):
            generators = (generators,)
        self.generators = tuple(g for g in generators if g is not None)
        self.key = None
        self.graph = None
        self.stream = None
        self.static: Dict[str, torch.Tensor] = {}
        self.loss = None
        self.launches: Counter = Counter()
        self.with_twin = twin
        self.twin = None
        self.twin_loss = None
        self.twin_launches: Counter = Counter()
        self.replayed_twin = False

    def _key(self, arrays, inputs) -> tuple:
        opt = self.optimizer
        held = [t for g in opt.param_groups for t in (*g["params"], g["lr"])]
        held += [t for st in opt.state.values() for t in st.values()]
        return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())),
                tuple((k, v.data_ptr(), tuple(v.shape)) for k, v in sorted(arrays.items())),
                tuple(t.data_ptr() for t in held if isinstance(t, torch.Tensor)))

    def __call__(self, arrays, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of one step on ``inputs`` (``views`` and any fed
        draws); the replayed graph's own loss buffer after a replay."""
        with layer_range("step.feed"):
            ready = self.key is not None and self._key(arrays, inputs) == self.key
            if ready:
                for k, v in inputs.items():
                    self.static[k].copy_(v)
        if not ready:
            return self._capture(arrays, inputs)
        marked = self.with_twin and profiling.ranges_on()
        with layer_range("step.replay"):
            if marked:
                if not self.replayed_twin:
                    profiling.reset_ranges(self.static["views"].device)
                self.twin.replay()
            else:
                self.graph.replay()
        self.replayed_twin = marked
        _build.LAUNCHES.update(self.twin_launches if marked else self.launches)
        return self.twin_loss if marked else self.loss

    def _capture(self, arrays, inputs) -> torch.Tensor:
        dev = inputs["views"].device
        # free the old graphs' pool
        self.key = self.graph = self.loss = self.twin = self.twin_loss = None
        if self.with_twin:
            profiling.range_buffer(dev)            # made outside every graph's pool
        self.static = {}
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            loss = self.step(arrays, inputs["views"],
                             **{k: v for k, v in inputs.items() if k != "views"})
        main.wait_stream(self.stream)
        loss.record_stream(main)
        self.static = {k: v.clone() for k, v in inputs.items()}
        self.graph, self.loss, self.launches = self._record(arrays)
        if self.with_twin:
            self.twin, self.twin_loss, self.twin_launches = self._record(
                arrays, pool=self.graph.pool(), marked=True)
        self.replayed_twin = False
        self.key = self._key(arrays, inputs)
        return loss

    def _record(self, arrays, pool=None, marked: bool = False):
        """Capture the step on the static inputs (with range marks when
        ``marked``): (graph, its loss buffer, the launches it recorded)."""
        static = self.static
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = Counter(_build.LAUNCHES)
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                with (profiling.marking(static["views"].device) if marked
                      else contextlib.nullcontext()):
                    static_loss = self.step(
                        arrays, static["views"],
                        **{k: v for k, v in static.items() if k != "views"})
        except Exception as exc:
            raise RuntimeError(
                f"capturing the training step in a CUDA graph failed: "
                f"{type(exc).__name__}: {exc}") from exc
        finally:
            recorded = Counter(_build.LAUNCHES)
            recorded.subtract(before)
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)
        return graph, static_loss, +recorded


def make_epoch_fn(cfg: Dict[str, Any], field: DensityField, optimizer,
                  steps_per_epoch: int, *, n_rays: int, n_batch: int,
                  use_mask: bool, generator: Optional[torch.Generator],
                  field_fine: Optional[DensityField] = None,
                  geo=None, near: float = 0.0, far: float = 0.0) -> Callable:
    """One epoch of training steps (the JAX ``make_epoch_fn``'s role).

    Returns ``fn(arrays, view_order [steps, n_batch], start_step, *,
    draws=None, timer=None) -> losses [steps]`` (on the device), with
    ``fn.step`` the step it runs (eagerly: ``Trainer.train_step``).  Step
    ``i`` is :func:`make_train_step`'s step on ``view_order[i]`` at the
    rate ``schedule(start_step + i)``; ``draws`` maps names of
    :data:`DRAWS` to per-step draws ([steps, ...]) fed in place of the
    generator's; ``timer.tick()`` (a ``StepTimer``) marks the end of every
    step.

    On the CPU the steps run eagerly, one after another.  On the card the
    view order (and any draws) goes to the device once, the only place
    where the host touches the device in an epoch; the first step the
    function runs is eager, then one step is captured as a CUDA graph
    (``_GraphedStep``) and every further step is a device copy of its views
    into the graph's buffer and a replay, after which its loss is copied
    into ``losses[i]``.  No step waits for the device.  The graph is kept
    across epochs and captured again only when a shape changes or a tensor
    it reads moved.  The rate is filled into Adam's device tensor between
    steps (once per epoch with the StepLR schedule).
    """
    step = make_train_step(cfg, field, optimizer, n_rays=n_rays, n_batch=n_batch,
                           use_mask=use_mask, generator=generator,
                           field_fine=field_fine, geo=geo, near=near, far=far)
    return epoch_loop(step, _GraphedStep(step, optimizer, generator), optimizer,
                      make_lr_schedule(cfg, steps_per_epoch),
                      lambda dev: dev.type == "cuda")


def epoch_loop(step: Callable, graphed: "_GraphedStep", optimizer,
               schedule: Callable[[int], float],
               graphed_on: Callable[[torch.device], bool]) -> Callable:
    """The epoch function of :func:`make_epoch_fn` over ``step`` (``step(
    arrays, views, **draws) -> loss``, which sets no rate): the rate of
    ``schedule`` filled in between the steps, and each step through
    ``graphed`` where ``graphed_on(device)`` holds, else eagerly.  Host
    ranges (``utils/profiling.py``, open while a profiler runs): ``epoch``
    around the call, ``epoch.stage`` around the staging of the view order
    and draws, ``step`` around each step, with ``step.set_lr``,
    ``step.feed`` and ``step.replay`` (``_GraphedStep``) and ``step.loss``
    inside it."""

    def fn(arrays, view_order, start_step: int, *, draws=None, timer=None):
        with layer_range("epoch"):
            with layer_range("epoch.stage"):
                dev = arrays["pools"].device
                views = torch.as_tensor(view_order, dtype=torch.long, device=dev)
                fed = {k: torch.as_tensor(v, device=dev) for k, v in (draws or {}).items()}
                unknown = set(fed) - set(DRAWS)
                if unknown:
                    raise ValueError(f"unknown draws {sorted(unknown)}; the step "
                                     f"takes {DRAWS}")
                capture = graphed_on(dev)
                losses = torch.empty(views.shape[0], device=dev)
            lr = None
            for i in range(views.shape[0]):
                with layer_range("step"):
                    with layer_range("step.set_lr"):
                        if schedule(start_step + i) != lr:
                            lr = schedule(start_step + i)
                            set_lr(optimizer, lr)
                    if capture:
                        inputs = {"views": views[i], **{k: v[i] for k, v in fed.items()}}
                        loss = graphed(arrays, inputs)
                    else:
                        loss = step(arrays, views[i], **{k: v[i] for k, v in fed.items()})
                    with layer_range("step.loss"):
                        losses[i] = loss
                    if timer is not None:
                        timer.tick()
            return losses

    fn.step, fn.graphed = step, graphed
    return fn


# --------------------------------------------------------------------------
# Orchestrator
# --------------------------------------------------------------------------

class Trainer:
    """Reference-shaped trainer.  Subclass and override ``eval_step`` for
    custom evals."""

    def __init__(self, cfg: Dict[str, Any], workdir: Optional[str] = None,
                 device=None):
        from ..parallel.mesh import MeshSpec

        cfg = with_defaults(cfg)
        self.cfg = cfg
        # ``parallel.mesh`` larger than one device, or a mesh of one under
        # ``force_mesh``, selects the sharded step (parallel/step.py) over
        # the ranks of the process group, one device a rank.
        par = cfg["parallel"]
        mspec = MeshSpec.from_config(par.get("mesh"))
        sharded = mspec.n_devices > 1 or bool(par.get("force_mesh"))
        self.device = resolve_device(device)
        if sharded and self.device.type == "cuda":
            # a rank's card: cuda:(LOCAL_RANK % count) by default, else the
            # one named, or the current one for a bare "cuda"
            if self.device.index is None:
                index = (int(os.environ.get("LOCAL_RANK", 0)) if device is None
                         else torch.cuda.current_device())
                self.device = torch.device("cuda", index % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        pin_fp32()
        self.n_fine = int(cfg["render"]["n_fine"])
        self.epochs = int(cfg["train"]["epoch"])
        self.i_eval = int(cfg["log"]["i_eval"])
        self.i_save = int(cfg["log"]["i_save"])
        self.n_rays = int(cfg["train"]["n_rays"])
        self.n_batch = int(cfg["train"]["n_batch"])

        self.expdir = workdir or osp.join(cfg["exp"]["expdir"], cfg["exp"]["expname"])
        self.ckptdir = osp.join(self.expdir, "ckpt")
        self.evaldir = osp.join(self.expdir, "eval")

        self.mesh = None
        self._group_store = None   # the store file of a group this trainer made
        if sharded:
            from ..parallel.mesh import make_mesh
            self._join_group(mspec)
            self.mesh = make_mesh(mspec, self.device.type)
        self.rank = dist.get_rank() if self.mesh is not None else 0
        if self.rank == 0:
            os.makedirs(self.evaldir, exist_ok=True)

        datadir = cfg["exp"]["datadir"]
        ray_mode = str(cfg["train"].get("ray_mode", "auto"))
        self.train_dset = load_dataset(datadir, "train", self.n_rays,
                                       device=self.device, ray_mode=ray_mode)
        self.eval_dset = (load_dataset(datadir, "val", self.n_rays,
                                       device=self.device, ray_mode=ray_mode)
                          if self.i_eval > 0 and self.rank == 0 else None)
        self.use_mask = bool(float(self.train_dset.mask.min()) < 1.0)
        self.steps_per_epoch = max(1, self.train_dset.n_views // self.n_batch)

        seed = int(cfg["train"].get("seed", 42))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.field = build_model(cfg, self.generator, self.device)
        self.field_fine = (build_model(cfg, self.generator, self.device)
                           if self.n_fine > 0 else None)
        self.optimizer = make_optimizer(cfg, self._parameters())
        self.schedule = make_lr_schedule(cfg, self.steps_per_epoch)
        self._arrays = self.train_dset.arrays()
        ds = self.train_dset
        # ``train_steps`` runs the epoch function, ``train_step`` its step
        # eagerly; on a mesh the sharded epoch function
        kw = dict(n_rays=self.n_rays, n_batch=self.n_batch, use_mask=self.use_mask,
                  field_fine=self.field_fine, geo=ds.geo, near=ds.near, far=ds.far)
        if self.mesh is not None:
            from ..parallel.step import make_sharded_epoch_fn

            self._epoch_fn = make_sharded_epoch_fn(
                cfg, self.field, self.optimizer, self.mesh, self.steps_per_epoch,
                self.generator, **kw)
            # this rank's draws: the generator folded with its data index
            self.generator = self._epoch_fn.generator
        else:
            self._epoch_fn = make_epoch_fn(
                cfg, self.field, self.optimizer, self.steps_per_epoch,
                generator=self.generator, **kw)

        self.epoch_start = 0
        self.global_step = 0
        self.last_epoch = 0
        self.losses: List[float] = []    # every step's loss, in order
        self.step_ms: List[float] = []   # every step's time (device stream)
        self.eval_metrics: Dict[int, Dict[str, float]] = {}  # epoch -> metrics

        if cfg["train"]["resume"] and self._checkpoints():
            self.restore()
        if self.mesh is not None:
            self._check_replicas()

        self.logger = None
        if self.rank == 0:
            self.logger = ExperimentLogger(self.expdir)
            self.logger.add_text("parameters", json.dumps(_jsonable(cfg), indent=2))

    # -- process group -----------------------------------------------------
    def _join_group(self, mspec) -> None:
        """Use the initialized process group; for a mesh of one with none,
        make a one-rank group (NCCL on the card, gloo on the CPU) on a
        ``FileStore`` in the work directory.  A larger mesh needs its
        processes launched together."""
        if dist.is_initialized():
            return
        if mspec.n_devices > 1:
            raise RuntimeError(
                f"parallel.mesh {mspec} needs {mspec.n_devices} processes, one a "
                f"device, and no process group is initialized: launch with "
                f"torchrun --nproc-per-node {mspec.n_devices} -m "
                f"neuralvolumetricreconstructionformedicalimages_torch.train.cli "
                f"--config ...")
        from ..parallel.mesh import DEFAULT_TIMEOUT_S

        os.makedirs(self.expdir, exist_ok=True)
        path = osp.join(self.expdir, "process_group.store")
        if osp.exists(path):
            os.remove(path)          # a store left by a run that did not close
        cuda = self.device.type == "cuda"
        dist.init_process_group(
            "nccl" if cuda else "gloo", store=dist.FileStore(path, 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
            device_id=self.device if cuda else None)
        self._group_store = path

    def close(self) -> None:
        """Destroy the process group this trainer made (if it made one)."""
        if self._group_store is not None:
            dist.destroy_process_group()
            if osp.exists(self._group_store):
                os.remove(self._group_store)
            self._group_store = None

    def _parameters(self) -> List[torch.nn.Parameter]:
        return [p for f in (self.field, self.field_fine) if f is not None
                for p in f.parameters()]

    def _check_replicas(self) -> None:
        """Fail unless every rank holds the same parameters: each tensor's
        sum and sum of squares (f64), their minimum over the ranks equal to
        their maximum."""
        sums = torch.stack([torch.stack([p.detach().double().sum(),
                                         p.detach().double().square().sum()])
                            for p in self._parameters()]).reshape(-1)
        lo, hi = sums.clone(), sums.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        if not torch.equal(lo, hi):
            raise RuntimeError(
                f"rank {self.rank}: the ranks' parameters differ (per-tensor sums "
                f"span {lo.tolist()} .. {hi.tolist()})")

    def _all_ranks(self, flag: bool) -> bool:
        """``flag`` of any rank, on every rank (a decision all ranks take)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # -- persistence -----------------------------------------------------
    def _checkpoints(self) -> List[str]:
        """Checkpoint files, oldest epoch first."""
        paths = glob.glob(osp.join(self.ckptdir, "ckpt_*.pt"))
        return sorted(paths, key=lambda p: int(re.findall(r"(\d+)\.pt$", p)[0]))

    def save(self, epoch: int) -> None:
        """Checkpoint ``epoch``.  On a mesh every rank calls it: rank 0
        writes and the ranks meet at a barrier after the write."""
        if self.rank == 0:
            os.makedirs(self.ckptdir, exist_ok=True)
            state = {
                "epoch": epoch,
                "field": self.field.state_dict(),
                "field_fine": (self.field_fine.state_dict()
                               if self.field_fine is not None else None),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
            }
            path = osp.join(self.ckptdir, f"ckpt_{epoch:06d}.pt")
            torch.save(state, path + ".tmp")
            os.replace(path + ".tmp", path)
            for old in self._checkpoints()[:-2]:   # keep the newest two
                os.remove(old)
        if self.mesh is not None:
            dist.barrier()

    def restore(self) -> None:
        """Load the newest checkpoint; on a mesh every rank loads the same
        one and draws from its saved generator folded with the rank's data
        index (as at the start)."""
        path = self._checkpoints()[-1]
        state = torch.load(path, map_location=self.device)
        self.field.load_state_dict(state["field"])
        if self.field_fine is not None:
            self.field_fine.load_state_dict(state["field_fine"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
        if self.mesh is not None:
            from ..parallel.step import draw_generator
            self.generator.set_state(draw_generator(self.generator, self.mesh).get_state())
            self._epoch_fn.refold_noise()
        self.epoch_start = int(state["epoch"]) + 1
        self.global_step = self.epoch_start * self.steps_per_epoch
        if self.rank == 0:
            print(f"[RESUME] from epoch {state['epoch']} ({path})")

    # -- schedules -------------------------------------------------------
    def _view_order(self, epoch: int) -> np.ndarray:
        """[steps_per_epoch, n_batch] view indices, sequential (optionally
        shuffled per epoch)."""
        n = self.train_dset.n_views
        order = np.arange(n)
        if self.cfg["train"].get("shuffle_views"):
            order = np.random.default_rng(epoch).permutation(n)
        usable = self.steps_per_epoch * self.n_batch
        return order[:usable].reshape(self.steps_per_epoch, self.n_batch)

    def current_lr(self) -> float:
        return float(self.schedule(self.global_step))

    # -- loop ------------------------------------------------------------
    def train_step(self, views) -> torch.Tensor:
        """One eager optimizer step on ``n_rays`` pixels of each view in
        ``views`` (on a mesh, of the global batch); returns the (device)
        loss without waiting for it.  The step of :meth:`train_steps`,
        uncaptured; ``views`` already on the device costs no host copy."""
        views = torch.as_tensor(views, dtype=torch.long, device=self.device)
        set_lr(self.optimizer, self.schedule(self.global_step))
        loss = self._epoch_fn.step(self._arrays, views)
        self.global_step += 1
        return loss

    def train_steps(self, view_order, timer: Optional[StepTimer] = None
                    ) -> torch.Tensor:
        """The steps of ``view_order`` ([steps, n_batch]) from
        ``global_step`` on through the epoch function (on a mesh the sharded
        one): a replayed CUDA graph on the card (on a mesh, under NCCL).
        Returns the losses [steps] on the device; ``timer.tick()`` after
        every step."""
        losses = self._epoch_fn(self._arrays, view_order, self.global_step,
                                timer=timer)
        self.global_step += len(view_order)
        return losses

    def start(self, deadline: Optional[float] = None) -> None:
        """Main loop.  ``deadline``: optional absolute ``time.time()``;
        training stops cleanly between epochs once it has passed."""
        main = self.rank == 0
        t_start = time.time()
        for idx_epoch in range(self.epoch_start, self.epochs + 1):
            if self._all_ranks(deadline is not None and time.time() > deadline):
                if main:
                    print(f"[deadline] stopping before epoch {idx_epoch} "
                          f"({time.time() - t_start:.0f}s elapsed)")
                break
            self.last_epoch = idx_epoch
            if main and self.i_eval > 0 and (idx_epoch % self.i_eval == 0
                                             or idx_epoch == self.epochs):
                metrics = self.eval_step(self.global_step, idx_epoch)
                self.eval_metrics[idx_epoch] = metrics
                msg = ", ".join(f"{k}: {v:.4g}" for k, v in metrics.items())
                print(f"[EVAL] epoch: {idx_epoch}/{self.epochs}, {msg}")

            timer = StepTimer(self.device)
            timer.tick()
            losses = self.train_steps(self._view_order(idx_epoch), timer).cpu().numpy()
            ms = timer.step_ms()
            self.losses.extend(float(x) for x in losses)
            self.step_ms.extend(ms)
            if main and not np.isfinite(losses).all():
                print(f"! [Numerical Error] epoch {idx_epoch}: loss contains "
                      f"nan/inf ({losses})")

            if main:
                self.logger.add_scalar("train/loss", float(losses.mean()),
                                       self.global_step)
                self.logger.add_scalar("train/lr", self.current_lr(), self.global_step)
            if main and (idx_epoch % 25 == 0 or idx_epoch == self.epochs):
                rate = self.n_rays * self.n_batch / (np.median(ms) / 1e3)
                print(f"epoch={idx_epoch}/{self.epochs} loss={losses.mean():.4g} "
                      f"lr={self.current_lr():.3g} rays/s={rate:,.0f} "
                      f"elapsed={time.time() - t_start:.0f}s")

            if (self.i_save > 0 and idx_epoch > 0
                    and (idx_epoch % self.i_save == 0 or idx_epoch == self.epochs)):
                if main:
                    print(f"[SAVE] epoch: {idx_epoch}/{self.epochs}, "
                          f"path: {self.ckptdir}")
                self.save(idx_epoch)
        if main:
            self.logger.flush()
            print(f"Training complete! See logs in {self.expdir}")

    # -- eval ------------------------------------------------------------
    def eval_step(self, global_step: int, idx_epoch: int) -> Dict[str, float]:
        """Render one random val view in full and query the voxel grid;
        projection MSE/PSNR and 3D PSNR/SSIM plus artifacts.  With
        ``log.eval_mask`` the beam mask multiplies gt and prediction."""
        dset = self.eval_dset
        assert dset is not None
        sel = int(np.random.default_rng(idx_epoch).integers(dset.n_views))
        projs_gt = dset.projs[sel].cpu().numpy().astype(np.complex64)
        H, W = projs_gt.shape
        rays = dset.view_rays(sel)

        # Prebuild the rolled gather tables once per eval, outside the tiles.
        coarse = self.field.freeze()
        fine = self.field_fine.freeze() if self.field_fine is not None else None
        acc = render_image(
            rays, self.field, n_samples=int(self.cfg["render"]["n_samples"]),
            tile=min(4096, H * W), n_fine=self.n_fine, field_fine=self.field_fine,
            enc_params=coarse, enc_params_fine=fine)
        projs_pred = acc.cpu().numpy().reshape(H, W).astype(np.complex64)

        if bool(self.cfg["log"].get("eval_mask", False)):
            beam_mask = dset.mask[sel].cpu().numpy().astype(np.complex64)
            projs_gt = projs_gt * beam_mask
            projs_pred = projs_pred * beam_mask

        metrics: Dict[str, float] = {
            "proj_mse": get_mse(projs_pred, projs_gt),
            "proj_psnr": get_psnr(projs_pred, projs_gt),
        }
        image_gt = dset.image.cpu().numpy() if dset.image is not None else None
        image_pred = None
        if image_gt is not None and dset.voxels is not None:
            netchunk = int(self.cfg["render"].get("netchunk", 262144))
            use_fine = self.n_fine > 0 and self.field_fine is not None
            image_pred = query_field(
                dset.voxels, self.field_fine if use_fine else self.field,
                tile=netchunk, enc_params=fine if use_fine else coarse
            )[..., 0].cpu().numpy()
            metrics["psnr_3d"] = get_psnr_3d(image_pred, image_gt)
            metrics["ssim_3d"] = get_ssim_3d(image_pred, image_gt)

        self.logger.add_scalars(metrics, global_step, prefix="eval/")

        eval_save_dir = osp.join(self.evaldir, f"epoch_{idx_epoch:05d}")
        os.makedirs(eval_save_dir, exist_ok=True)
        show_proj = np.concatenate([projs_gt, projs_pred], axis=1)
        self.logger.add_image("eval/projection (left: gt, right: pred)",
                              cast_to_image(show_proj), global_step)
        if image_pred is not None:
            show_slice = 5
            show_step = max(1, image_gt.shape[-1] // show_slice)
            rows = []
            for i_show in range(show_slice):
                k = min(i_show * show_step, image_gt.shape[-1] - 1)
                rows.append(np.concatenate(
                    [image_gt[..., k], image_pred[..., k]], axis=0))
            show_density = np.concatenate(rows, axis=1)
            self.logger.add_image("eval/density (row1: gt, row2: pred)",
                                  cast_to_image(show_density), global_step)
            np.save(osp.join(eval_save_dir, "image_pred.npy"), image_pred)
            np.save(osp.join(eval_save_dir, "image_gt.npy"), image_gt)
            _save_png(osp.join(eval_save_dir, "slice_show_row1_gt_row2_pred.png"),
                      cast_to_image(show_density))
        _save_png(osp.join(eval_save_dir, "proj_show_left_gt_right_pred.png"),
                  cast_to_image(show_proj))
        with open(osp.join(eval_save_dir, "stats.txt"), "w") as f:
            for key, value in metrics.items():
                f.write("%s: %f\n" % (key, value))
        return metrics


def _save_png(path: str, img01: np.ndarray) -> None:
    """Write channel 0 of ``img01`` ([H, W, C] in [0, 1]) as an 8-bit
    grayscale PNG of ``clip * 255`` (the bytes the JAX package hands to
    ``imageio``), with the standard library alone."""
    img = np.ascontiguousarray((np.clip(img01[..., 0], 0, 1) * 255).astype(np.uint8))
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # each row behind filter byte 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj
