"""AdamW over trees of torch tensors, with optional block-quantized 8-bit
moments (the port of ``repro.train.optimizer``: the same names,
defaults, state layout and arithmetic).

The optimizer state is ``{"m": tree, "v": tree, "step": int32
scalar}``. Moments are float32, bfloat16, or, with ``moments="int8"``,
per-leaf ``{"q": int8 (rows, block), "scale": float32 (rows, 1)}``:
the flattened moment in blocks of ``block`` values, each scaled by its
absmax / 127 and rounded half to even (``torch.round``, as
``jnp.round``), the rows padded with zeros to a multiple of
``_SHARD_PAD`` so that ``q`` and ``scale`` have the JAX package's shapes
(its padding lets the quantized state shard on any mesh). Updates are
functional: ``adamw_update`` returns new tensors, as the JAX function
does. ``opt_state_specs`` gives the state's logical axes (the moments
mirror the params; int8 moments shard their block rows FSDP-style).

On DTensors (a sharded train step) int8 moments keep that global
layout: ``adamw_update`` moves each gradient and parameter into its
moments' block rows with explicit collectives, updates the rows there
and moves the parameter back (``_Rows``), so the gathered state equals
the single-device one bit for bit and no rank holds more of a leaf's
float32 moment than its rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments: str = "float32"     # float32 | bfloat16 | int8
    block: int = 256             # int8 quantization block


# ----------------------------------------------------------- int8 moments

_SHARD_PAD = 512  # block rows padded to a multiple (the JAX package's)


def _q8(x: torch.Tensor, block: int) -> dict:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    rowpad = (-blocks.shape[0]) % _SHARD_PAD
    if rowpad:
        blocks = torch.nn.functional.pad(blocks, (0, 0, 0, rowpad))
    return _quantize(blocks)


def _quantize(blocks: torch.Tensor) -> dict:
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dq8(s: dict, shape) -> torch.Tensor:
    blocks = s["q"].float() * s["scale"]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


# ------------------------------------------- int8 moments on DTensors
#
# On a mesh the quantized state keeps the JAX layout globally: q and
# scale hold the block rows of the row-major flattening of the GLOBAL
# moment, sharded over the mesh dims that shard q's dim 0 (the row
# group, F ranks: row rank r holds the flat range [r N/F, (r+1) N/F) of
# the N = R x block padded elements) and replicated over the others. A
# step moves the gradient and the parameter into that layout, updates
# each rank's rows there (the moments never leave it) and moves the new
# parameter back, with explicit collectives:
#   1. DTensor gathers the mesh dims outside the row group that shard
#      the leaf (the rows are replicated there): FORCED["opt8_gather"];
#   2. per row mesh dim, innermost first, an all-to-all (or a local
#      chunk where the leaf is replicated) makes every row mesh dim shard
#      one tensor dim k that F divides: row rank g then holds chunk
#      pos[g] of dim k, a run of W elements in each line of L = F W;
#   3. one all-to-all over the row group re-cuts those runs into the
#      rows' flat ranges.
# So no rank holds more than an F-th of a leaf in float32. A leaf with
# no dim that F divides is gathered whole instead and each rank keeps
# its rows: FORCED["opt8_replicate"].

def _ravel(coords, sizes) -> int:
    i = 0
    for c, s in zip(coords, sizes):
        i = i * s + c
    return i


def _a2a(x: torch.Tensor, out_sizes, in_sizes, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), out_sizes, in_sizes, group))


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    fn = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return funcol.wait_tensor(fn(x.contiguous(), dim, group))


def _swap(x: torch.Tensor, z: int, split: int, cat: int, group):
    """All-to-all over a mesh dim of `z` ranks: `x` cut in z along dim
    `split`, piece i to rank i; the pieces received joined along dim
    `cat` in rank order."""
    pieces = x.chunk(z, dim=split)
    shape = list(pieces[0].shape)
    got = _a2a(torch.cat([t.reshape(-1) for t in pieces]), None, None,
               group)
    got = got.view(z, *shape).movedim(0, cat)
    shape[cat] *= z
    return got.reshape(shape)


def _group(mesh, dims: list):
    """The process group of `mesh`'s dims `dims` (ranks in row-major
    order over them)."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    from torch.utils._python_dispatch import _disable_current_modes

    names = tuple(mesh.mesh_dim_names[j] for j in dims)
    with _disable_current_modes():      # the mesh's own index tensors
        return mesh[names]._flatten().get_group()


class _Rows:
    """The route of one leaf between its DTensor layout and the int8
    block rows of its moments (the comment above). Raises, naming the
    leaf and the placements, where no route exists."""

    def __init__(self, x, q, name: str):
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.sharding.constrain import FORCED, is_dtensor

        def fail(why):
            raise ValueError(
                f"int8 moments of {name}: {why} (leaf placements "
                f"{getattr(x, 'placements', 'plain tensor')}, q placements "
                f"{getattr(q, 'placements', 'plain tensor')})")
        if not (is_dtensor(x) and is_dtensor(q)) \
                or x.device_mesh != q.device_mesh:
            fail("the leaf and its moments are not DTensors on one mesh")
        if any(type(p) not in (Shard, Replicate) for p in x.placements):
            fail("no route from these leaf placements")
        if any(not (type(p) is Replicate or (type(p) is Shard and p.dim == 0))
               for p in q.placements):
            fail("no route to these q placements")
        mesh = self.mesh = q.device_mesh
        sizes = tuple(mesh.shape)
        self.shape, self.placements = tuple(x.shape), tuple(x.placements)
        self.q_placements = tuple(q.placements)
        self.rows, self.block = tuple(q.shape)
        rd = self.row_dims = [j for j, p in enumerate(q.placements)
                              if isinstance(p, Shard)]
        F = self.F = math.prod(sizes[j] for j in rd)
        self.n, self.N = math.prod(self.shape), self.rows * self.block
        if self.N % F or self.n > self.N:
            fail(f"{self.rows} rows of {self.block} do not hold "
                 f"{self.n} elements in {F} even shards")
        self.coord = mesh.get_coordinate()
        self.me = _ravel([self.coord[j] for j in rd], [sizes[j] for j in rd])
        gathered = [p if j in rd else Replicate()
                    for j, p in enumerate(x.placements)]
        if gathered != list(x.placements):
            FORCED["opt8_gather"] += 1
        cands = [d for d, s in enumerate(self.shape) if s % F == 0]
        self.k, self.steps = None, []
        if F > 1 and not cands:
            gathered = [Replicate()] * mesh.ndim
            FORCED["opt8_replicate"] += 1
        elif F > 1:
            self.k = k = max(cands, key=lambda d: (
                sum(gathered[j] == Shard(d) for j in rd), -d))
            nest = [j for j in rd if gathered[j] == Shard(k)]
            for j in reversed(rd):
                if gathered[j] != Shard(k):
                    p = gathered[j]
                    self.steps.append((j, p.dim if isinstance(p, Shard)
                                       else None))
                    nest.append(j)
            self.pos = []
            for g in range(F):
                c, rest = {}, g
                for j in reversed(rd):
                    c[j], rest = rest % sizes[j], rest // sizes[j]
                self.pos.append(_ravel([c[j] for j in nest],
                                       [sizes[j] for j in nest]))
            self.W = self.shape[k] // F * math.prod(self.shape[k + 1:])
            self.L = F * self.W
        self.gathered = tuple(gathered)
        if F > 1:
            self.group = _group(mesh, rd)

    # -- the flat ranges and the runs
    def _range(self, r: int) -> tuple:
        per = self.N // self.F
        return min(r * per, self.n), min((r + 1) * per, self.n)

    def _count(self, c: int, f: int) -> int:
        """Elements of chunk position c whose flat index is below f."""
        return f // self.L * self.W + min(max(f % self.L - c * self.W, 0),
                                          self.W)

    def _runs(self, c: int, r: int) -> int:
        a, b = self._range(r)
        return self._count(c, b) - self._count(c, a)

    def _lines(self) -> tuple:
        """This rank's flat range as (head sizes by chunk position, full
        lines, tail sizes by chunk position); (sizes, None, None) when
        it lies within one line."""
        a, b = self._range(self.me)
        W, L = self.W, self.L

        def overlap(x, y):
            return [max(0, min(y, (c + 1) * W) - max(x, c * W))
                    for c in range(self.F)]
        if a == b:
            return [0] * self.F, None, None
        pa, pb = a // L, (b - 1) // L
        if pa == pb:
            return overlap(a - pa * L, b - pa * L), None, None
        return overlap(a - pa * L, L), pb - pa - 1, overlap(0, b - pb * L)

    # -- the two directions
    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `x` (a DTensor of the leaf's global
        shape), flat, zero-padded to N/F elements."""
        if tuple(x.placements) != self.gathered:
            x = x.redistribute(self.mesh, list(self.gathered))
        local = x.to_local()
        per = self.N // self.F
        if self.k is None:
            flat = torch.nn.functional.pad(local.reshape(-1),
                                           (0, self.N - self.n))
            return flat.narrow(0, self.me * per, per)
        sizes = tuple(self.mesh.shape)
        for j, d in self.steps:
            if d is None:
                local = local.chunk(sizes[j], dim=self.k)[self.coord[j]]
            else:
                local = _swap(local, sizes[j], self.k, d,
                              self.mesh.get_group(j))
        recv = [self._runs(self.pos[g], self.me) for g in range(self.F)]
        got = _a2a(local.reshape(-1), recv,
                   [self._runs(self.pos[self.me], r) for r in range(self.F)],
                   self.group)
        head, full, tail = self._lines()
        by_pos = [None] * self.F
        for g, t in enumerate(got.split(recv)):
            by_pos[self.pos[g]] = t
        if full is None:
            flat = torch.cat(by_pos)
        else:
            parts = [t.split([h, full * self.W, e])
                     for t, h, e in zip(by_pos, head, tail)]
            mid = torch.stack([p[1] for p in parts]).view(
                self.F, full, self.W).transpose(0, 1).reshape(-1)
            flat = torch.cat([p[0] for p in parts] + [mid]
                             + [p[2] for p in parts])
        return torch.nn.functional.pad(flat, (0, per - flat.numel()))

    def from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The DTensor, in the leaf's placements, whose rows on this
        rank are `rows` (flat, N/F elements)."""
        from torch.distributed.tensor import DTensor

        sizes = tuple(self.mesh.shape)
        if self.k is None:
            full = rows if self.F == 1 else _gather(rows, 0, self.group)
            local = full.narrow(0, 0, self.n).view(self.shape)
        else:
            a, b = self._range(self.me)
            data = rows.narrow(0, 0, b - a)
            head, full, tail = self._lines()
            if full is None:
                by_pos = list(data.split(head))
            else:
                h, m, e = data.split([sum(head), full * self.L, sum(tail)])
                mid = m.view(full, self.F, self.W).transpose(0, 1) \
                    .contiguous()
                by_pos = [torch.cat([hp, mid[c].reshape(-1), ep])
                          for c, (hp, ep) in enumerate(zip(h.split(head),
                                                           e.split(tail)))]
            local = _a2a(torch.cat([by_pos[self.pos[g]]
                                    for g in range(self.F)]),
                         [self._runs(self.pos[self.me], r)
                          for r in range(self.F)],
                         [self._runs(self.pos[g], self.me)
                          for g in range(self.F)], self.group)
            shape = list(self.shape)
            shape[self.k] //= self.F
            local = local.view(shape)
            for j, d in reversed(self.steps):
                group = self.mesh.get_group(j)
                local = _gather(local, self.k, group) if d is None else \
                    _swap(local, sizes[j], d, self.k, group)
        stride = [math.prod(self.shape[i + 1:])
                  for i in range(len(self.shape))]
        y = DTensor.from_local(local.contiguous(), self.mesh,
                               list(self.gathered), shape=self.shape,
                               stride=tuple(stride), run_check=False)
        if self.gathered != self.placements:
            y = y.redistribute(self.mesh, list(self.placements))
        return y

    def quantize(self, rows: torch.Tensor) -> dict:
        """{"q", "scale"} DTensors in the moments' layout of this rank's
        float32 rows."""
        from torch.distributed.tensor import DTensor

        s = _quantize(rows.view(-1, self.block))
        pl = list(self.q_placements)
        return {"q": DTensor.from_local(s["q"], self.mesh, pl,
                                        shape=(self.rows, self.block),
                                        stride=(self.block, 1),
                                        run_check=False),
                "scale": DTensor.from_local(s["scale"], self.mesh, pl,
                                            shape=(self.rows, 1),
                                            stride=(1, 1), run_check=False)}


def _local(x):
    """A replicated DTensor scalar's value (a plain value as it is)."""
    from repro_torch.sharding.constrain import is_dtensor

    return x.full_tensor() if is_dtensor(x) else x


def _encode_moment(x: torch.Tensor, cfg: OptConfig):
    if cfg.moments == "int8":
        return _q8(x, cfg.block)
    if cfg.moments == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def _decode_moment(s, cfg: OptConfig, shape=None) -> torch.Tensor:
    if cfg.moments == "int8":
        return _dq8(s, shape)
    return s.float()


# ----------------------------------------------------------------- trees

def _flatten(tree, is_leaf=lambda x: False) -> list:
    """Leaves of a nested dict in sorted-key order (jax.tree's order)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return [x for k in sorted(tree) for x in _flatten(tree[k], is_leaf)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def _paths(tree, prefix="") -> list:
    """The "a/b/c" names of ``_flatten``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "q" in x


# ----------------------------------------------------------------- adamw

def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moments``' encoding, step 0 (int32), on
    the params' device."""
    leaves = _flatten(params)
    dev = leaves[0].device if leaves else None

    def zeros():
        return _unflatten(params, [
            _encode_moment(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), cfg)
            for p in leaves])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs, cfg: OptConfig):
    """Moment shardings mirror the params (plus scale arrays for int8)."""
    def lift(ax):
        if cfg.moments == "int8":
            # quantized layout is flattened, nblocks padded to _SHARD_PAD:
            # shard the block rows FSDP-style
            return {"q": ("fsdp", None), "scale": ("fsdp", None)}
        return ax

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return lift(node)
    moments = walk(param_specs)
    return {"m": moments, "v": moments, "step": None}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares, the sums added in leaf order."""
    total = None
    for g in _flatten(tree):
        s = g.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state: dict, cfg: OptConfig) -> tuple:
    """One AdamW step with global-norm clipping: (new params, new
    optimizer state, the gradients' global norm before clipping).
    Int8 moments on DTensors are updated in their block-row layout
    (``_Rows``)."""
    from repro_torch.sharding.constrain import is_dtensor

    step = opt_state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd_rows(p, g, m_s, v_s, name):
        """``upd`` on DTensors with int8 moments, run on this rank's
        block rows (the same operators on the same values, so the same
        bits as on one device)."""
        route = _Rows(p, m_s["q"], name)
        g = route.to_rows(g).float() * _local(scale)

        def dq(s):
            return (s["q"].to_local().float() * s["scale"].to_local()) \
                .reshape(-1)
        m = cfg.b1 * dq(m_s) + (1 - cfg.b1) * g
        v = cfg.b2 * dq(v_s) + (1 - cfg.b2) * g.square()
        mh = m / _local(c1)
        vh = v / _local(c2)
        pf = route.to_rows(p).float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        new_p = route.from_rows((pf - cfg.lr * delta).to(p.dtype))
        return new_p, route.quantize(m), route.quantize(v)

    def upd(p, g, m_s, v_s, name):
        if cfg.moments == "int8" and (is_dtensor(p) or is_dtensor(m_s["q"])):
            return upd_rows(p, g, m_s, v_s, name)
        g = g.float() * scale
        m = _decode_moment(m_s, cfg, p.shape)
        v = _decode_moment(v_s, cfg, p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * delta).to(p.dtype)
        return new_p, _encode_moment(m, cfg), _encode_moment(v, cfg)

    flat_p = _flatten(params)
    flat_g = _flatten(grads)
    flat_m = _flatten(opt_state["m"], _is_q8)
    flat_v = _flatten(opt_state["v"], _is_q8)
    names = _paths(params)
    out = [upd(*leaf) for leaf in zip(flat_p, flat_g, flat_m, flat_v, names)]
    new_params = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, gn
