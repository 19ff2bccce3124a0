"""The benchmark's inputs and its plain reference of NAF's training step.

Imports nothing of the program, of the JAX package or of JAX.  Everything
here follows the published definitions (NAF, Zha et al., MICCAI 2022; the
multiresolution hash grid of Instant-NGP with the coherent linear hash;
TIGRE's cone-beam geometry; Adam) and the precision that the cell's
configuration states, in plain PyTorch with TF32 off.

- :func:`make_scan`: the dataset of a configuration, made from a seed: the
  cone-beam views of an analytic phantom (a sum of ellipsoids of constant
  density, each chord through each ellipsoid taken exactly), in the
  reference pickle format that the program loads.
- :func:`make_weights`: the initial table and MLP, on the device, from a
  seed, in two calls of one generator.
- :func:`draw_epoch`: the per-step draws (pool draw and stratified jitter)
  that both sides are fed.
- :class:`Reference`: the training step (batch gather, stratified samples,
  coherent hash encoder forward and backward, MLP, Beer-Lambert sum,
  MSE, Adam), with a control in TF32 and a step that leaves half of the
  batch out.

It covers the coherent linear hash in 3-D, untilted cone-beam scans and
the MSE loss with no fine pass; it refuses other hashes and scans.  A
configuration that needs more (NAF's XOR-prime hash, a tilted or
laminographic scan, the coarse-to-fine pass, the TV loss) names a module
of its own under its key ``reference`` (``run.load_reference``), which
supplies ``make_scan``, ``make_weights``, ``layer_dims``, ``corner_rows``
and ``reference_readings`` and may take any of them from here.  The
seeded streams, :func:`draw_epoch` and the judging (:func:`compare`,
:func:`norms`, :func:`change_norms`) are always this module's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Sub-seed streams drawn from the run's seed (PROGRAM: the generator the
# program is handed, whose draws the fed ones replace).
PHANTOM, WEIGHTS, DRAWS, PROGRAM = 0, 1, 2, 3
# Linear-hash multipliers of the coherent hash on hashed levels (x keeps
# neighbouring cells adjacent; y and z are the reference hash's primes).
LINEAR_MULTIPLIERS = (1, 19349663, 83492791)
_LEAKY_SLOPE = 0.01
_ADAM_BETAS, _ADAM_EPS = (0.9, 0.999), 1e-8


def sub_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of draws of the run's ``seed`` (any
    whole number)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(sub_seed(seed, stream))
    return gen


# --------------------------------------------------------------------------
# Scan geometry (TIGRE convention) and the analytic phantom
# --------------------------------------------------------------------------

class Geometry:
    """A cone-beam scan in metres from the configuration's ``scan`` group
    (millimetres, as in the reference pickles)."""

    def __init__(self, scan: Dict):
        if scan["mode"] != "cone" or float(scan.get("tilt_angle", 0)) != 0:
            raise ValueError("the reference covers untilted cone-beam scans")
        self.DSD = float(scan["DSD"]) / 1000.0
        self.DSO = float(scan["DSO"]) / 1000.0
        self.W, self.H = (int(n) for n in scan["nDetector"])
        self.dDet = [float(x) / 1000.0 for x in scan["dDetector"]]
        self.offDet = [float(x) / 1000.0 for x in scan["offDetector"]][:2]
        self.sVoxel = [n * d / 1000.0 for n, d in zip(scan["nVoxel"], scan["dVoxel"])]
        self.offOrigin = [float(x) / 1000.0 for x in scan["offOrigin"]]
        n = int(scan["numTrain"])
        step = math.radians(float(scan["totalAngle"])) / n
        self.angles = (math.radians(float(scan["startAngle"]))
                       + np.arange(n) * step).astype(np.float64)

    def near_far(self, tolerance: float = 0.005) -> Tuple[float, float]:
        """Near and far planes from the largest in-plane distance of the
        volume's corners."""
        dist = max(math.hypot(self.offOrigin[0] + sx * self.sVoxel[0] / 2,
                              self.offOrigin[1] + sy * self.sVoxel[1] / 2)
                   for sx in (-1, 1) for sy in (-1, 1))
        return (max(0.0, self.DSO - dist - tolerance),
                min(2 * self.DSO, self.DSO + dist + tolerance))

    def rotations(self, angles: torch.Tensor) -> torch.Tensor:
        """[N, 3, 3] f32 rotation of the source/detector frame: R3(angle, z)
        @ R2(pi/2, z) @ R1(-pi/2, x), taken in float64."""
        a = angles.to(torch.float32).to(torch.float64)
        c, s = torch.cos(a), torch.sin(a)
        p1, p2 = -math.pi / 2, math.pi / 2
        r1 = torch.tensor([[1.0, 0.0, 0.0],
                           [0.0, math.cos(p1), -math.sin(p1)],
                           [0.0, math.sin(p1), math.cos(p1)]], dtype=torch.float64)
        r2 = torch.tensor([[math.cos(p2), -math.sin(p2), 0.0],
                           [math.sin(p2), math.cos(p2), 0.0],
                           [0.0, 0.0, 1.0]], dtype=torch.float64)
        r21 = (r2 @ r1).to(a.device)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        r3 = torch.stack([torch.stack([c, -s, zero], -1),
                          torch.stack([s, c, zero], -1),
                          torch.stack([zero, zero, one], -1)], -2)
        return (r3 @ r21).to(torch.float32)

    def rays(self, angles: torch.Tensor, pix: torch.Tensor):
        """Origins and (unnormalised) directions [N, P, 3] f32 of the flat
        detector pixels ``pix`` [N, P] of the views at ``angles`` [N]."""
        rows = torch.div(pix, self.W, rounding_mode="floor")
        cols = pix - rows * self.W
        u = (cols.to(torch.float32) + 0.5 - self.W / 2) * self.dDet[0] + self.offDet[0]
        v = (rows.to(torch.float32) + 0.5 - self.H / 2) * self.dDet[1] + self.offDet[1]
        local = torch.stack([u / self.DSD, v / self.DSD, torch.ones_like(u)], -1)
        rot = self.rotations(angles)                              # [N, 3, 3]
        d = (rot[:, None, :, :] * local[:, :, None, :]).sum(-1)
        a = angles.to(torch.float32).to(torch.float64)
        o = torch.stack([self.DSO * torch.cos(a), self.DSO * torch.sin(a),
                         torch.zeros_like(a)], -1).to(torch.float32)
        return o[:, None, :].expand_as(d), d


def make_scan(cfg: Dict, seed: int, device) -> Tuple[Dict, torch.Tensor]:
    """The cell's training views: (the pickle-format dict the program
    loads, the projections [N, H, W] f32 on ``device``).  Each pixel holds
    the line integral of the phantom's density along its ray (metres),
    the sum over ellipsoids of density x chord length."""
    geo = Geometry(cfg["scan"])
    dev = torch.device(device)
    angles = torch.as_tensor(geo.angles, device=dev)
    pix = torch.arange(geo.W * geo.H, device=dev)[None].expand(len(geo.angles), -1)
    o, d = geo.rays(angles, pix)
    o, d = o.to(torch.float64), d.to(torch.float64)
    proj = torch.zeros(d.shape[:2], dtype=torch.float64, device=dev)
    # each ellipsoid's density, scaled by a factor drawn from the seed
    ph = cfg["phantom"]
    dens = np.array([e[6] for e in ph["ellipsoids"]], np.float64)
    jitter = float(ph["density_jitter"])
    dens = dens * np.random.default_rng(sub_seed(seed, PHANTOM)).uniform(
        1 - jitter, 1 + jitter, dens.shape)
    dnorm = torch.linalg.vector_norm(d, dim=-1)
    for e, rho in zip(ph["ellipsoids"], dens):
        centre = torch.tensor(e[0:3], dtype=torch.float64, device=dev)
        axes = torch.tensor(e[3:6], dtype=torch.float64, device=dev)
        q, w = (o - centre) / axes, d / axes
        a = (w * w).sum(-1)
        b = 2.0 * (q * w).sum(-1)
        c = (q * q).sum(-1) - 1.0
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        proj += float(rho) * torch.sqrt(disc) / a * dnorm
    proj = proj.to(torch.float32).reshape(-1, geo.H, geo.W)
    data = {k: v for k, v in cfg["scan"].items()}
    data["train"] = {"projections": proj.cpu().numpy(), "angles": geo.angles}
    return data, proj


# --------------------------------------------------------------------------
# Weights and draws
# --------------------------------------------------------------------------

def layer_dims(cfg: Dict) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each linear layer: the encoded input is joined
    to the hidden state before each layer of ``skips``."""
    net, enc = cfg["network"], cfg["encoder"]
    in_dim = int(enc["num_levels"]) * int(enc["level_dim"])
    hidden, n = int(net["hidden_dim"]), int(net["num_layers"])
    skips = [int(s) for s in net["skips"]]
    dims = [(in_dim, hidden)]
    dims += [(hidden + (in_dim if i in skips else 0), hidden) for i in range(1, n - 1)]
    return dims + [(hidden, int(net["out_dim"]))]


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial parameters by name: the table U(-1e-4, 1e-4) [L, 2^T, C]
    and each layer's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    NAF's initialisation, drawn in two calls on ``device``."""
    enc = cfg["encoder"]
    gen = generator(seed, WEIGHTS, device)
    shape = (int(enc["num_levels"]), 1 << int(enc["log2_hashmap_size"]),
             int(enc["level_dim"]))
    out = {"table": torch.rand(shape, generator=gen, device=device) * 2e-4 - 1e-4}
    dims = layer_dims(cfg)
    flat = torch.rand(sum(i * o + o for i, o in dims), generator=gen,
                      device=device) * 2 - 1
    k = 0
    for j, (i, o) in enumerate(dims):
        bound = 1.0 / math.sqrt(i)
        out[f"layers.{j}.weight"] = flat[k:k + i * o].reshape(o, i) * bound
        k += i * o
        out[f"layers.{j}.bias"] = flat[k:k + o] * bound
        k += o
    return out


def draw_epoch(gen: torch.Generator, counts: torch.Tensor, views: torch.Tensor,
               n_rays: int, n_samples: int,
               out: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """The draws of the steps of ``views`` [steps, n_batch]: ``r`` [steps,
    n_batch, n_rays], uniform over the valid pixels of each step's views
    (``counts`` of each view), and ``t_rand`` [steps, n_batch * n_rays,
    n_samples], the jitter within each depth bin.  ``out`` refills the
    buffers of an earlier call in place, with the same values a fresh call
    would draw."""
    steps, n_batch = views.shape
    dev = views.device
    u_shape = (steps, n_batch, n_rays)
    t_shape = (steps, n_batch * n_rays, n_samples)
    if out is None:
        u = torch.rand(u_shape, generator=gen, device=dev)
        t_rand = torch.rand(t_shape, generator=gen, device=dev)
    else:
        u = torch.rand(u_shape, generator=gen, device=dev, out=out["u"])
        t_rand = torch.rand(t_shape, generator=gen, device=dev, out=out["t_rand"])
    cnt = counts[views].to(torch.float32)[:, :, None]
    r = torch.minimum((u * cnt).long(), cnt.long() - 1)
    if out is not None:
        out["r"].copy_(r)
        return out
    return {"u": u, "r": r, "t_rand": t_rand}


# --------------------------------------------------------------------------
# The coherent hash grid
# --------------------------------------------------------------------------

class HashGrid:
    """Levels, scales and the linear hash of the grid of ``cfg["encoder"]``:
    level l has scale 2^l * base - 1 and resolution ceil(scale) + 1; a
    level whose (res + 1)^3 corners fit the table is dense (row-major
    strides), the others hash g -> (g . a) mod 2^T."""

    def __init__(self, enc: Dict):
        if enc.get("hash_variant", "coherent") != "coherent" or int(enc["input_dim"]) != 3:
            raise ValueError("the reference covers the coherent hash in 3-D")
        self.L = int(enc["num_levels"])
        self.C = int(enc["level_dim"])
        self.S = 1 << int(enc["log2_hashmap_size"])
        levels = np.arange(self.L, dtype=np.float64)
        self.scales = (np.exp2(levels) * int(enc["base_resolution"]) - 1.0).astype(np.float32)
        res_p1 = np.ceil(self.scales.astype(np.float64)).astype(np.int64) + 2
        mult = np.zeros((self.L, 3), np.int64)
        for l in range(self.L):
            if res_p1[l] ** 3 <= self.S:
                mult[l] = [1, res_p1[l], res_p1[l] ** 2]
            else:
                mult[l] = LINEAR_MULTIPLIERS
        self.mult = mult
        bits = (np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1     # [K, 3]
        self.bits = bits
        self.offsets = (mult[:, None, :] * bits[None]).sum(-1) & (self.S - 1)  # [L, K]
        self.quantized = bool(enc.get("pack_sort", False))
        self.bf16_table = enc.get("table_dtype", "float32") == "bfloat16"

    def corners(self, x01: torch.Tensor):
        """Flat table rows [P, L, 8] (level l's rows start at l * 2^T) and
        trilinear weights [P, L, 8] f32 of points ``x01`` [P, 3] in [0, 1].
        With ``pack_sort`` the in-cell positions are quantised to 11, 11 and
        10 bits, as the configuration states."""
        dev = x01.device
        scales = torch.as_tensor(self.scales, device=dev)
        pos = x01[:, None, :] * scales[None, :, None]               # [P, L, 3]
        pos = pos + 0.5
        grid = torch.floor(pos)
        frac = pos - grid
        mult = torch.as_tensor(self.mult, device=dev)
        base = (grid.to(torch.int64) * mult[None]).sum(-1) & (self.S - 1)
        offs = torch.as_tensor(self.offsets, device=dev)
        rows = (base[:, :, None] + offs[None]) & (self.S - 1)
        rows = rows + torch.arange(self.L, device=dev)[None, :, None] * self.S
        if self.quantized:
            hi = torch.tensor([2047.0, 2047.0, 1023.0], device=dev)
            q = torch.minimum(torch.clamp(frac * hi + 0.5, min=0.0), hi).to(torch.int32)
            frac = torch.stack([q[..., 0].to(torch.float32) * (1.0 / 2047.0),
                                q[..., 1].to(torch.float32) * (1.0 / 2047.0),
                                q[..., 2].to(torch.float32) * (1.0 / 1023.0)], -1)
        w = []
        for k in range(8):
            t = [frac[..., d] if self.bits[k, d] else 1.0 - frac[..., d] for d in range(3)]
            w.append(t[0] * t[1] * t[2])
        return rows, torch.stack(w, -1)


def corner_rows(cfg: Dict, x01: torch.Tensor) -> torch.Tensor:
    """Flat table rows [P, L, 8] of the corners of points ``x01`` [P, 3] in
    [0, 1], for the count of distinct rows a step touches."""
    return HashGrid(cfg["encoder"]).corners(x01)[0]


class _Encode(torch.autograd.Function):
    """Hash-grid features [P, L*C]: per level the weighted sum of the 8
    corner rows in corner order (rows rounded to bf16 when the table is
    gathered in bf16, features rounded to bf16 with packed payloads).  The
    table's gradient is the weighted sum of the features' gradient into
    the corner rows, in f32."""

    @staticmethod
    def forward(ctx, x01, table, grid):
        rows, w = grid.corners(x01)
        tab = table.detach()
        if grid.bf16_table:
            tab = tab.to(torch.bfloat16).to(torch.float32)
        vals = tab.reshape(-1, grid.C)[rows]                      # [P, L, 8, C]
        acc = w[..., 0, None] * vals[:, :, 0]
        for k in range(1, 8):
            acc = acc + w[..., k, None] * vals[:, :, k]
        if grid.quantized:
            acc = acc.to(torch.bfloat16).to(torch.float32)
        ctx.save_for_backward(rows, w)
        ctx.table_shape = table.shape
        return acc.reshape(x01.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        L, S, C = ctx.table_shape
        contrib = w[..., None] * g.reshape(g.shape[0], L, 1, C)     # [P, L, 8, C]
        grad = torch.zeros((L * S, C), dtype=torch.float32, device=g.device)
        grad.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
        return None, grad.reshape(L, S, C), None


# --------------------------------------------------------------------------
# The training step
# --------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits, nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """``x @ w.T + b`` with every product's operands rounded to TF32 and
    the sums in f32: the arithmetic of a TF32 GEMM, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _tf32(x) @ _tf32(w).t() + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g32 = _tf32(g)
        return g32 @ _tf32(w), g32.t() @ _tf32(x), g.sum(0)


class Reference:
    """NAF's training step on the benchmark's scan, from ``weights``.

    ``tf32`` computes every GEMM in TF32 (the control: the precision below
    the configuration's f32 with TF32 off); ``keep < 1`` leaves the rest of
    the batch out of the loss and takes the mean over the rays kept (a
    fault the comparison has to catch).
    """

    def __init__(self, cfg: Dict, proj: torch.Tensor,
                 weights: Dict[str, torch.Tensor], *, steps_per_epoch: int,
                 tf32: bool = False, keep: float = 1.0):
        self.cfg = cfg
        self.geo = Geometry(cfg["scan"])
        self.grid = HashGrid(cfg["encoder"])
        self.proj = proj
        dev = proj.device
        self.angles = torch.as_tensor(self.geo.angles, device=dev)
        flat = proj.reshape(proj.shape[0], -1)
        self.pools = [torch.nonzero(flat[i] != 0).squeeze(1) for i in range(flat.shape[0])]
        self.params = {k: v.detach().clone() for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.n_layers = len(layer_dims(cfg))
        self.tf32, self.keep = tf32, float(keep)
        self.steps_per_epoch = steps_per_epoch
        self.last_points: Optional[torch.Tensor] = None

    def lr(self) -> float:
        tr = self.cfg["train"]
        epoch = self.t // self.steps_per_epoch
        return float(tr["lrate"]) * float(tr["lrate_gamma"]) ** math.floor(
            epoch / int(tr["lrate_step"]))

    def _field(self, x: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        net = self.cfg["network"]
        bound = float(net["bound"])
        x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
        self.last_points = x01.detach()
        h = _Encode.apply(x01, params["table"], self.grid)
        inp = h
        skips = [int(s) for s in net["skips"]]
        for i in range(self.n_layers):
            if i in skips:
                h = torch.cat([inp, h], -1)
            w, b = params[f"layers.{i}.weight"], params[f"layers.{i}.bias"]
            h = _TF32Linear.apply(h, w, b) if self.tf32 else F.linear(h, w, b)
            if i < self.n_layers - 1:
                h = F.leaky_relu(h, _LEAKY_SLOPE)
        act = net["last_activation"]
        if act == "sigmoid":
            return torch.sigmoid(h)
        if act == "tanh":
            return torch.tanh(h)
        if act == "relu":
            return F.leaky_relu(h, _LEAKY_SLOPE)
        if act == "none":
            return h
        raise ValueError(f"unknown last activation {act!r}")

    def loss(self, views: torch.Tensor, r: torch.Tensor, t_rand: torch.Tensor,
             params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of one step: ``r`` [n_batch, n_rays] pool draws of the
        views ``views`` [n_batch], ``t_rand`` [n_batch * n_rays, S]."""
        pix = torch.stack([self.pools[int(v)][r[j]] for j, v in enumerate(views.tolist())])
        target = torch.stack([self.proj[int(v)].reshape(-1)[pix[j]]
                              for j, v in enumerate(views.tolist())]).reshape(-1)
        o, d = self.geo.rays(self.angles[views], pix)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        near, far = self.geo.near_far()
        n_samples = int(self.cfg["render"]["n_samples"])
        t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=o.device)
        near_t = torch.full((o.shape[0], 1), near, dtype=torch.float32, device=o.device)
        far_t = torch.full((o.shape[0], 1), far, dtype=torch.float32, device=o.device)
        z = near_t * (1.0 - t) + far_t * t
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * t_rand
        bound = float(self.cfg["network"]["bound"]) - 1e-6
        pts = torch.clamp(o[:, None, :] + d[:, None, :] * z[:, :, None], -bound, bound)
        sigma = self._field(pts.reshape(-1, 3), params).reshape(o.shape[0], n_samples)
        dists = z[:, 1:] - z[:, :-1]
        dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e-10)], -1)
        dists = dists * torch.linalg.vector_norm(d[:, None, :], dim=-1)
        acc = torch.sum(sigma * dists, -1)
        n = max(1, int(round(acc.shape[0] * self.keep)))
        return torch.mean((target[:n] - acc[:n]) ** 2)

    def step(self, views, r, t_rand) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One Adam step; returns the loss and the gradients by name."""
        params = {k: v.requires_grad_(True) for k, v in self.params.items()}
        loss = self.loss(views, r, t_rand, params)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        lr = self.lr()
        self.t += 1
        b1, b2 = _ADAM_BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k in names:
                g = grads[k]
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                update = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + _ADAM_EPS)
                self.params[k] = (self.params[k].detach() - lr * update).detach()
        return float(loss.detach()), grads


# --------------------------------------------------------------------------
# What a run is judged by
# --------------------------------------------------------------------------

def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's 2-norm, taken in float64 on the host."""
    return {k: float(np.linalg.norm(v.detach().cpu().numpy().astype(np.float64).ravel()))
            for k, v in tensors.items()}


def change_norms(after: Dict[str, torch.Tensor],
                 before: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Each leaf's 2-norm of ``after - before`` in float64 (``before`` on
    the host)."""
    return {k: float(np.linalg.norm((v.detach().cpu().numpy().astype(np.float64)
                                     - before[k].astype(np.float64)).ravel()))
            for k, v in after.items()}


def reference_readings(cfg: Dict, proj: torch.Tensor, weights: Dict[str, torch.Tensor],
                       draws: Dict[str, torch.Tensor], views: torch.Tensor, *,
                       steps: int, steps_per_epoch: int, tf32: bool = False,
                       keep: float = 1.0, points=None) -> Dict:
    """The readings of the reference over the first ``steps`` steps (views
    ``views[i]``, draws ``draws[..][i]``): each step's loss, each leaf's
    first gradient's norm and each leaf's change after the last step.
    ``points(i, x01)``, where given, sees each step's encoded points."""
    ref = Reference(cfg, proj, weights, steps_per_epoch=steps_per_epoch,
                    tf32=tf32, keep=keep)
    before = {k: v.detach().cpu().numpy().copy() for k, v in ref.params.items()}
    losses, first = [], None
    for i in range(steps):
        loss, grads = ref.step(views[i], draws["r"][i], draws["t_rand"][i])
        losses.append(loss)
        if first is None:
            first = norms(grads)
        if points is not None:
            points(i, ref.last_points)
        del grads
    return {"loss": losses, "grad": first, "change": change_norms(ref.params, before)}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([ref[k] for k in ref]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]
    return float(max(gaps)) if all(np.isfinite(gaps)) else float("inf")


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: ``loss_gap``, the largest relative gap of a
    step's loss; ``grad_gap``, the worst leaf's gap of the first gradient's
    norm; ``change_gap``, the worst leaf's gap of the change's norm, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf below that moves under Adam by round-off)."""
    lp, lr = np.asarray(prog["loss"], np.float64), np.asarray(ref["loss"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    if not np.isfinite(loss_gap):
        loss_gap = float("inf")
    med = float(np.median(list(ref["grad"].values())))
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], list(ref["grad"])),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}
