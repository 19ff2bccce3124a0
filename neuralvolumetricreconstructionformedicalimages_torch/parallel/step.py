"""Sharded training steps on a named ``(data, sample)`` mesh of ranks.

Port of the JAX ``parallel/step.py``, one process a device:

- **Params replicated, rays data-parallel.**  Every rank starts from the
  same parameters; each rank of the ``data`` axis draws its own rays from
  the generator folded with its data index, renders them, and the
  gradients are all-reduced once over the whole mesh.
- **Exact global loss.**  Every mean of the loss all-reduces its numerator
  and its denominator over the ``data`` group before the division
  (``losses.get_loss_fn(name, group)``), so the value is the unsharded
  loss of the concatenated batch, also when the mask sums differ per rank.
- **Optional sample-axis split.**  The ranks of a ``sample`` group hold
  the same rays and integrate one contiguous z-slab each; the partial
  line integrals ``sum(sigma * dt)`` are all-reduced.  The z grid comes
  from a generator that is not folded with the sample index, so every
  slab agrees on it.
- **The true gradient, once.**  Each rank's autograd sees only its own
  share of each all-reduced sum (``losses.global_sum``), so the one SUM
  all-reduce of the flat gradient over data x sample gives exactly the
  gradient of the global loss.  The JAX step psums a gradient that its
  shard_map already summed, and so applies ``n_data * n_sample`` times it
  (ROADMAP Queue 3).

The optimizer update runs replicated on every rank (identical inputs,
identical outputs).

``make_sharded_epoch_fn`` is the counterpart of JAX's jitted ``shard_map``
epoch: on a card whose group runs NCCL the first step is eager (it also
makes every communicator the step uses), then one step is captured as a
CUDA graph and replayed for every further step, so the host only launches
replays.  Gloo stages its collectives through the host, which a graph
cannot hold: under gloo, and on the CPU, the steps run eagerly.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..data.dataset import gather_batch
from ..losses import get_loss_fn, global_sum
from ..models.density_field import DensityField
from ..ops.sampling import stratified_z_vals
from ..ops import _build
from ..train.optim import make_lr_schedule, set_lr
from ..train.trainer import _GraphedStep, epoch_loop, make_loss_fn
from .mesh import DATA_AXIS, SAMPLE_AXIS


def fold_generator(generator: torch.Generator, index: int) -> torch.Generator:
    """A new generator on ``generator``'s device, seeded from its state and
    ``index`` (the counterpart of ``jax.random.fold_in``): equal states and
    indices give equal streams, other indices other streams.  The parent
    is not advanced."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.sha256(state + int(index).to_bytes(8, "little")).digest()
    out = torch.Generator(device=generator.device)
    out.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return out


def all_reduce_grads(params: List[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over all ranks with one all-reduce of
    one flat buffer; each ``.grad`` becomes a view of the summed buffer.

    Safe to capture: in a CUDA graph the buffer is allocated once, from the
    graph's pool, and every replay rewrites it at the same address, which
    the captured Adam reads through the ``.grad`` views.  Counted as
    ``_build.LAUNCHES["all_reduce_grads"]`` (a replay counts what its
    capture recorded)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    _build.LAUNCHES["all_reduce_grads"] += 1
    for p, g in zip(params, torch.split(flat, [g.numel() for g in grads])):
        p.grad = g.view_as(p)


def graphs_collectives(device: torch.device) -> bool:
    """Whether the sharded step is captured on ``device``: on a card whose
    collectives run on NCCL.  Gloo stages every collective through the
    host, which a CUDA graph cannot hold, so under gloo (and on the CPU)
    the steps run eagerly.  This is a branch by backend, not a fallback."""
    if device.type != "cuda":
        return False
    backend = str(dist.get_backend())
    # "nccl", or a map of device types to backends ("cpu:gloo,cuda:nccl")
    return backend == "nccl" or "cuda:nccl" in backend.split(",")


def _render_acc_sample_sharded(
    rays: torch.Tensor,
    field: DensityField,
    *,
    n_samples: int,
    local_samples: int,
    sample_index: int,
    group,
    perturb: bool,
    raw_noise_std: float,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    noise_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Beer-Lambert accumulation with the depth-sample axis split over the
    ranks of ``group``.  Every rank computes the whole (cheap) z grid and
    its interval lengths, slices its slab of ``local_samples``, queries the
    field there and all-reduces the partial integrals; autograd reaches
    only this rank's slab.

    Matches ``render_rays`` + ``raw2outputs`` for the coarse pass.  The
    jitter comes from ``generator`` (or ``t_rand``, the whole grid's), the
    noise ([rays, local_samples]) from ``noise_generator`` (the step's
    generator folded with ``sample_index`` once, when the step is built)
    or ``noise``.
    """
    rays_o, rays_d = rays[..., :3], rays[..., 3:6]
    near, far = rays[..., 6:7], rays[..., 7:8]

    do_perturb = perturb and (generator is not None or t_rand is not None)
    z = stratified_z_vals(near, far, n_samples, do_perturb,
                          generator=generator, t_rand=t_rand)
    # the intervals of the whole grid, then the slab: per slab, the last
    # interval of every slab but the last would be 1e-10
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e-10)], dim=-1)
    dists = dists * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)
    lo = sample_index * local_samples
    z_loc = z[..., lo:lo + local_samples]
    d_loc = dists[..., lo:lo + local_samples]

    bound = field.bound - 1e-6
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_loc[..., :, None]
    pts = torch.clamp(pts, -bound, bound)
    sigma = field(pts)[..., 0]
    if raw_noise_std > 0.0 and (noise is not None or noise_generator is not None):
        if noise is None:
            noise = torch.randn(sigma.shape, dtype=sigma.dtype, device=sigma.device,
                                generator=noise_generator)
        sigma = sigma + noise * raw_noise_std

    partial = torch.sum(sigma * d_loc, dim=-1)
    return global_sum(partial, group)


def _make_shard_body(cfg: Dict[str, Any], field: DensityField, optimizer,
                     n_rays: int, n_batch: int, use_mask: bool, mesh,
                     generator: Optional[torch.Generator] = None, *,
                     field_fine: Optional[DensityField] = None,
                     geo=None, near: float = 0.0, far: float = 0.0):
    """Per-rank step: ``step(arrays, views, *, batch=None, r=None,
    t_rand=None, noise=None) -> loss`` at the rate the optimizer holds (the
    step sets none: the caller fills it in between steps, so that a
    captured step reads it).  ``batch`` ([local rays] of
    ``rays``/``projs``/``mask``), ``r`` (this rank's pool draw), ``t_rand``
    and ``noise`` feed this rank's draws in place of ``generator``'s.

    ``step.generators`` are the generators a graph of the step must
    register: ``generator`` and, with the sample axis split and
    ``raw_noise_std > 0``, the noise generator, ``generator`` folded with
    the sample index once, here (distinct noise per slab, drawn on from
    step to step); ``step.refold_noise()`` folds it again from
    ``generator``'s state (after a restore set it)."""
    render_cfg = cfg["render"]
    n_samples = int(render_cfg["n_samples"])
    n_fine = int(render_cfg["n_fine"])
    perturb = bool(render_cfg["perturb"])
    raw_noise_std = float(render_cfg["raw_noise_std"])
    n_data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    n_sample = mesh.size(mesh.mesh_dim_names.index(SAMPLE_AXIS))

    if n_fine > 0 and n_sample > 1:
        raise NotImplementedError(
            "hierarchical fine pass + sample-axis sharding not supported; "
            "shard rays instead (all reference configs use n_fine=0)"
        )
    if n_rays % n_data != 0:
        raise ValueError(f"n_rays={n_rays} not divisible by data axis {n_data}")
    if n_samples % n_sample != 0:
        raise ValueError(
            f"n_samples={n_samples} not divisible by sample axis {n_sample}"
        )
    local_rays = n_rays // n_data
    local_samples = n_samples // n_sample

    loss_name = str(cfg["train"].get("loss", "mse"))
    if n_sample > 1 and "tv" in loss_name:
        raise NotImplementedError(
            "tv regularizer + sample-axis sharding not supported (the "
            "sample-sharded renderer does not expose sample points)"
        )
    data_group = mesh.get_group(DATA_AXIS)
    sample_group = mesh.get_group(SAMPLE_AXIS)
    sample_index = mesh.get_local_rank(SAMPLE_AXIS)
    loss_calc = get_loss_fn(loss_name, group=data_group)
    loss_rays = make_loss_fn(cfg, use_mask, group=data_group)
    params = [p for f in (field, field_fine) if f is not None for p in f.parameters()]
    noise_generator = (fold_generator(generator, sample_index)
                       if n_sample > 1 and raw_noise_std > 0.0 and generator is not None
                       else None)

    def loss_fn(batch, t_rand, noise):
        if n_sample > 1:
            acc = _render_acc_sample_sharded(
                batch["rays"], field, n_samples=n_samples,
                local_samples=local_samples, sample_index=sample_index,
                group=sample_group, perturb=perturb, raw_noise_std=raw_noise_std,
                generator=generator, t_rand=t_rand, noise=noise,
                noise_generator=noise_generator)
            return loss_calc(acc, batch["projs"], batch["mask"] if use_mask else None)[0]
        return loss_rays(field, field_fine, batch, generator, t_rand=t_rand, noise=noise)

    def step(arrays, views, *, batch=None, r=None, t_rand=None, noise=None):
        if batch is None:
            views = torch.as_tensor(views, dtype=torch.long,
                                    device=arrays["pools"].device)
            if tuple(views.shape) != (n_batch,):
                raise ValueError(f"views of shape {tuple(views.shape)}, the step "
                                 f"takes [{n_batch}]")
            batch = gather_batch(arrays, views, local_rays, generator, r=r, geo=geo,
                                 near=near, far=far)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, t_rand, noise)
        loss.backward()
        all_reduce_grads(params)
        optimizer.step()
        return loss.detach()

    def refold_noise():
        if noise_generator is not None:
            noise_generator.set_state(fold_generator(generator, sample_index).get_state())

    step.generator, step.noise_generator = generator, noise_generator
    step.generators = tuple(g for g in (generator, noise_generator) if g is not None)
    step.refold_noise = refold_noise
    return step


def draw_generator(generator: torch.Generator, mesh) -> torch.Generator:
    """The generator of this rank's pixel draws and jitter: ``generator``
    folded with the data index, left as it is for one data shard (a mesh
    of one then draws what the unsharded trainer draws)."""
    n_data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    if n_data == 1:
        return generator
    return fold_generator(generator, mesh.get_local_rank(DATA_AXIS))


def make_sharded_train_step(cfg: Dict[str, Any], field: DensityField, optimizer,
                            mesh, steps_per_epoch: int,
                            generator: torch.Generator, *,
                            n_rays: int, n_batch: int, use_mask: bool,
                            field_fine: Optional[DensityField] = None,
                            geo=None, near: float = 0.0, far: float = 0.0):
    """One sharded optimizer step on this rank, eager.

    Returns ``fn(arrays, views [n_batch], step, *, batch=None, t_rand=None,
    noise=None) -> loss``: the rate of ``schedule(step)`` set, then ``n_rays
    / data`` pixels of each view drawn from ``fn.generator`` (``generator``,
    folded with the data index when ``data > 1``), the loss of the global
    batch, and ``field``'s parameters updated by ``optimizer`` with the
    gradient of that loss.  ``geo``/``near``/``far`` enable the on-the-fly
    ray mode (see data/dataset.py).
    """
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    body = _make_shard_body(cfg, field, optimizer, n_rays, n_batch, use_mask, mesh,
                            draw_generator(generator, mesh), field_fine=field_fine,
                            geo=geo, near=near, far=far)

    def fn(arrays, views, step, *, batch=None, t_rand=None, noise=None):
        set_lr(optimizer, schedule(step))
        return body(arrays, views, batch=batch, t_rand=t_rand, noise=noise)

    fn.generator = body.generator
    return fn


def make_sharded_epoch_fn(cfg: Dict[str, Any], field: DensityField, optimizer,
                          mesh, steps_per_epoch: int,
                          generator: torch.Generator, *,
                          n_rays: int, n_batch: int, use_mask: bool,
                          field_fine: Optional[DensityField] = None,
                          geo=None, near: float = 0.0, far: float = 0.0):
    """One sharded epoch (the JAX ``make_sharded_epoch_fn``'s role: the
    host touches the device once per epoch).

    Returns ``fn(arrays, view_order [steps, n_batch], start_step, *,
    draws=None, timer=None) -> losses [steps]`` (on the device), the
    contract of ``train/trainer.py::make_epoch_fn``: step ``i`` is the
    sharded step on ``view_order[i]`` at the rate ``schedule(start_step +
    i)``, filled into the optimizer between the steps; ``draws`` feeds this
    rank's draws (``r`` [steps, n_batch, local rays], ``t_rand``,
    ``noise``).  ``fn.step`` is the step (eagerly: ``Trainer.train_step``),
    ``fn.generator`` this rank's draw generator, ``fn.graphed`` the
    ``_GraphedStep``, ``fn.refold_noise`` the step's.

    By backend (:func:`graphs_collectives`): on a card under NCCL the first
    step is eager -- it makes every NCCL communicator the step uses (the
    data group's, the sample group's and the whole mesh's) -- then one step
    is captured as a CUDA graph with the draw and noise generators
    registered, and every further step is a copy of its views into the
    graph's buffer and a replay.  A capture that fails raises.  Under gloo,
    and on the CPU, the steps run eagerly, one after another.
    """
    body = _make_shard_body(cfg, field, optimizer, n_rays, n_batch, use_mask, mesh,
                            draw_generator(generator, mesh), field_fine=field_fine,
                            geo=geo, near=near, far=far)
    graphed = _GraphedStep(body, optimizer, body.generators)
    fn = epoch_loop(body, graphed, optimizer, make_lr_schedule(cfg, steps_per_epoch),
                    graphs_collectives)
    fn.generator, fn.refold_noise = body.generator, body.refold_noise
    return fn
