"""Public wrappers of the hand-written kernels.

Dispatch is by where the tensor lies, and by nothing else: a CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version in
``ref``.  There is no switch that sends a CUDA tensor to the plain version
and no ``try`` that gives way to it.

The kernels mask their own edges, so nothing is padded here (odd batch
sizes and ``D = 130`` go straight through).  Each wrapper checks device,
dtype, shape and contiguity, allocates its output with ``torch.empty``,
launches on the current stream and does not synchronise.

Gradients.  When autograd needs one, ``embedding_bag``,
``dot_interaction`` and ``cin_layer`` go through a
``torch.autograd.Function`` whose backward is a kernel too (K1-bwd, K2-bwd,
K3-bwd) on a CUDA tensor, and the plain backward in ``ref`` on a CPU
tensor.  When none is needed (serving, or no input that requires grad) the
path is the forward alone, with no graph and no backward launch.  The
kernels without a backward kernel (``gram``, ``decode_attention``) raise on
a CUDA tensor that needs a gradient rather than hand back a result
autograd cannot see through.

DTensors.  ``embedding_bag``, ``dot_interaction`` and ``cin_layer`` take
``torch.distributed.tensor.DTensor`` arguments too: through
``local_map`` the wrapper is called again on each rank's local shards, so
a CUDA shard launches the kernel (and counts its launch), a CPU shard
takes the plain version, and the ``autograd.Function``s are the same.  A
batch split over a mesh axis (``Shard(0)``) stays split; every other split
of an activation is gathered before the kernel, and a replicated weight's
gradient is declared a partial sum over the batch's axes, so that it is
reduced.  A table split by columns looks up its columns locally and the
pooled columns are gathered after; a table split by rows looks up the
rows it holds (every other id reads one zero row appended to the local
shard) and the pooled partial sums are added across the axis.
``decode_attention`` takes DTensor KV caches: split by heads, each rank
attends with its heads; split over time, each rank attends over its slots
and returns its log-sum-exp, and the ranks are merged in rank order
(``_decode_on_shards``).

Fake tensors.  A fake tensor (``torch._subclasses.fake_tensor``), on
whatever device, is the accounting's: the wrapper checks what it checks on
the card, allocates the kernel's output (and K1-bwd's zeroed gradient and
scratch) with ``torch.empty`` / ``torch.zeros``, and records the kernel's
work (each kernel module's ``work``) with ``roofline.analysis``'s active
counters, in place of building and launching it.  No launch is counted.
The backward kernels are accounted the same way when autograd runs on fake
tensors.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import cin as _cin
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import interaction as _ix
from repro_torch.kernels import ref
from repro_torch.roofline import analysis as _roofline

_DTYPES = (torch.float32, torch.bfloat16)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by this process since the last reset."""
    return {"embedding_bag": _eb.launch_count, "dot_interaction": _ix.launch_count,
            "cin_layer": _cin.launch_count, "decode_attention": _da.launch_count,
            "embedding_bag_backward": _eb.backward_launch_count,
            "dot_interaction_backward": _ix.backward_launch_count,
            "cin_layer_backward": _cin.backward_launch_count}


def reset_launch_counts() -> None:
    _eb.launch_count = _eb.backward_launch_count = 0
    _ix.launch_count = _ix.backward_launch_count = 0
    _cin.launch_count = _cin.backward_launch_count = 0
    _da.launch_count = 0


def _account(name: str, work: tuple[dict[str, float], float]) -> None:
    """A kernel's work on fake tensors, to the active counters."""
    _roofline.record_kernel(name, *work)


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _no_backward_kernel(name: str, where: str, *xs: torch.Tensor) -> None:
    if xs[0].is_cuda and _needs_grad(*xs):
        raise NotImplementedError(
            f"{name} has no backward kernel on the GPU ({where}); call it under "
            f"torch.no_grad() or on CPU tensors")


def _require_contiguous(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous, got strides {x.stride()}")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *, mode: str = "sum",
                  check_indices: bool = False) -> torch.Tensor:
    """Pooled lookup, float32 Kahan accumulation, result in the table's dtype.

    ``table (V, D)``, ``idx (B, H)`` → ``(B, D)``; or stacked
    ``table (F, V, D)``, ``idx (B, F, H)`` → ``(B, F, D)`` in one launch
    (field ``f`` looks up table ``f``).  ``idx`` is int32 or int64 on the
    CPU, int32 on the GPU.  ``check_indices`` verifies ``0 <= idx < V``
    first — a debugging aid that synchronises; the kernel trusts its indices.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    stacked = table.ndim == 3
    if table.ndim not in (2, 3) or idx.ndim != table.ndim:
        raise ValueError(f"expected table (V, D) with idx (B, H) or table (F, V, D) "
                         f"with idx (B, F, H); got {tuple(table.shape)}, {tuple(idx.shape)}")
    if stacked and idx.shape[1] != table.shape[0]:
        raise ValueError(f"idx has {idx.shape[1]} fields, table has {table.shape[0]}")
    if idx.shape[-1] < 1:
        raise ValueError("a bag needs at least one lookup")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported (float32, bfloat16)")
    if idx.device != table.device:
        raise ValueError(f"idx lies on {idx.device}, table on {table.device}")
    if check_indices and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= table.shape[-2]:
            raise IndexError(f"indices span [{lo}, {hi}], table has {table.shape[-2]} rows")
    if isinstance(table, DTensor):
        return on_table_shards(
            table, idx, lambda t, ids: embedding_bag(t, ids.contiguous(), mode=mode,
                                                     check_indices=check_indices),
            idx.ndim - 1)
    if _needs_grad(table):
        return _EmbeddingBag.apply(table, idx, mode)
    return _embedding_bag(table, idx, mode)


# ------------------------------------------------------------------ DTensors


def _batch_only(x: DTensor) -> tuple:
    """x's placements with its batch split (``Shard(0)``) kept and every
    other split or partial sum made whole."""
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def _summed_over(batch: tuple) -> tuple:
    """The gradient placements of a weight replicated over the mesh: a
    partial sum over each axis the batch is split on."""
    return tuple(Partial() if p == Shard(0) else Replicate() for p in batch)


def _as_dtensor(x: torch.Tensor, like: DTensor) -> DTensor:
    """A plain tensor, the same on every rank, as a replicated DTensor."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def on_table_shards(table: DTensor, idx: torch.Tensor, lookup, n_split: int) -> DTensor:
    """``lookup(table, ids)`` of a DTensor table ``(..., V, D)`` on each
    rank's shards, whole along D.  A split of ``idx``'s first ``n_split``
    dims (the dims the output shares) stays where the table is whole, and
    the output is split as they are; elsewhere the ids are gathered.  A
    table split by columns looks up its columns, which are gathered after;
    a table split by rows looks up the rows it holds, every other id
    reading a zero row appended to the local shard, and the partial sums
    are added after.  The table's gradient is declared as what each rank
    holds: its own columns or rows, a partial sum over the ids' splits.
    ``embedding_bag``'s route, and ``layers.embedding.lookup``'s."""
    mesh = table.device_mesh
    idx = _as_dtensor(idx, table)
    v_dim, d_dim = table.ndim - 2, table.ndim - 1
    idx_pl = tuple(ip if ip.is_shard() and ip.dim < n_split and tp == Replicate()
                   else Replicate() for ip, tp in zip(idx.placements, table.placements))
    out_ndim = n_split + 1
    out_pl, grad_pl, row_axes = [], [], []
    for axis, (tp, ip) in enumerate(zip(table.placements, idx_pl)):
        if ip.is_shard():
            out_pl.append(ip)
            grad_pl.append(Partial())
        elif tp.is_shard(d_dim):
            out_pl.append(Shard(out_ndim - 1))
            grad_pl.append(tp)
        elif tp.is_shard(v_dim):
            out_pl.append(Partial())
            grad_pl.append(tp)
            row_axes.append(axis)
        elif tp == Replicate():
            out_pl.append(Replicate())
            grad_pl.append(Replicate())
        else:
            raise ValueError(f"no lookup for a table placed {table.placements}")
    if len(row_axes) > 1:
        raise ValueError(f"the table's rows are split over more than one axis: "
                         f"{table.placements}")
    if row_axes:
        # DTensor's row shards: ceil(V / m) rows each, the last ones fewer
        per = -(-table.shape[v_dim] // mesh.size(row_axes[0]))
        lo = mesh.get_local_rank(row_axes[0]) * per

    def local(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if row_axes:
            n = t.shape[v_dim]
            zero = t.new_zeros(t.shape[:v_dim] + (1,) + t.shape[v_dim + 1:])
            t = torch.cat([t, zero], dim=v_dim)
            ids = ids - lo
            ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
        return lookup(t, ids)

    out = local_map(local, out_placements=list(out_pl),
                    in_placements=(table.placements, idx_pl),
                    in_grad_placements=(tuple(grad_pl), idx_pl), device_mesh=mesh,
                    redistribute_inputs=True)(table, idx)
    return out.redistribute(mesh, [p if p.is_shard() and p.dim < n_split else Replicate()
                                   for p in out.placements])


def _on_batch_shards(fn, xs: tuple, weights: tuple = ()) -> DTensor:
    """``fn(*xs, *weights)`` on each rank's shards: the activations ``xs``
    keep the first one's batch split and are made whole along every other
    dim; the weights are replicated, their gradient a partial sum over the
    batch's axes; the output is split as the batch is."""
    like = next(x for x in xs + weights if isinstance(x, DTensor))
    xs = tuple(_as_dtensor(x, like) for x in xs)
    weights = tuple(_as_dtensor(w, like) for w in weights)
    pl = _batch_only(xs[0])
    rep = tuple(Replicate() for _ in pl)
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl,) * len(xs) + (rep,) * len(weights),
                     in_grad_placements=(pl,) * len(xs) + (_summed_over(pl),) * len(weights),
                     device_mesh=like.device_mesh, redistribute_inputs=True)(*xs, *weights)


def _embedding_bag(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    stacked = table.ndim == 3
    fake = is_fake(table)
    if not table.is_cuda and not fake:
        if stacked:
            return ref.embedding_bag_stacked(table, idx, mode=mode)
        return ref.embedding_bag(table, idx, mode=mode)

    if table.is_cuda:
        if idx.dtype != torch.int32:
            raise TypeError(f"idx must be int32 on the GPU, got {idx.dtype}")
        _require_contiguous("table", table)
        _require_contiguous("idx", idx)
    tables3 = table if stacked else table[None]
    idx3 = idx if stacked else idx[:, None, :]
    out = torch.empty((idx3.shape[0], tables3.shape[0], tables3.shape[2]),
                      dtype=table.dtype, device=table.device)
    if fake:
        b, f, h = idx3.shape
        _account("embedding_bag", _eb.work(b, f, h, tables3.shape[2], table.element_size()))
    elif out.numel():
        _eb.launch(tables3, idx3, out, mean=(mode == "mean"))
    return out if stacked else out[:, 0, :]


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor, vocab: int, *,
                           mode: str = "sum") -> torch.Tensor:
    """The tables' gradient of the stacked ``embedding_bag``: grad_out
    (B, F, D), idx (B, F, H) → (F, V, D) float32, dense and table-shaped;
    every lookup adds its bag's gradient row (÷H for ``mean``) into the row
    it read.  A CUDA tensor launches K1-bwd into a zeroed buffer (D <= 256;
    the same bits every launch; scratch of about 16 bytes a lookup, sized by
    the shapes alone, and no host synchronisation); a CPU tensor takes
    ``ref.embedding_bag_backward``."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    if grad_out.ndim != 3 or idx.ndim != 3 or grad_out.shape[:2] != idx.shape[:2]:
        raise ValueError(f"expected grad_out (B, F, D) and idx (B, F, H), got "
                         f"{tuple(grad_out.shape)}, {tuple(idx.shape)}")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"grad_out dtype {grad_out.dtype} not supported (float32, bfloat16)")
    if idx.device != grad_out.device:
        raise ValueError(f"idx lies on {idx.device}, grad_out on {grad_out.device}")
    fake = is_fake(grad_out)
    if not grad_out.is_cuda and not fake:
        return ref.embedding_bag_backward(grad_out, idx, vocab, mode=mode)
    if grad_out.is_cuda:
        if idx.dtype != torch.int32:
            raise TypeError(f"idx must be int32 on the GPU, got {idx.dtype}")
        if grad_out.shape[2] > _eb.MAX_BACKWARD_D:
            raise ValueError(f"the backward kernel takes D <= {_eb.MAX_BACKWARD_D}, "
                             f"got {grad_out.shape[2]}")
        _require_contiguous("grad_out", grad_out)
        _require_contiguous("idx", idx)
    b, f, h = idx.shape
    d = grad_out.shape[2]
    grad = torch.zeros((f, vocab, d), dtype=torch.float32, device=grad_out.device)
    if grad_out.numel() and h:
        # a fresh allocation starts on a 16-byte boundary on the card
        vectorized = (d * grad_out.element_size() % 16 == 0 if fake
                      else _eb.backward_vectorized(grad_out))
        plan = _eb.backward_plan(b, f, vocab, h, d, grad_out.element_size(), vectorized)
        scratch = {name: torch.empty(shape, dtype=dtype, device=grad_out.device)
                   for name, (shape, dtype) in _eb.backward_scratch(plan, b, f, h, d).items()}
        if fake:
            _account("embedding_bag_backward",
                     _eb.backward_work(b, f, h, d, grad_out.element_size()))
        else:
            _eb.launch_backward(grad_out, idx, grad, mean=(mode == "mean"), plan=plan,
                                scratch=scratch)
    return grad


class _EmbeddingBag(torch.autograd.Function):
    """K1 forward, K1-bwd backward (plain versions for CPU tensors).  The
    gradient is accumulated in float32 and cast once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx, mode):
        ctx.save_for_backward(idx)
        ctx.mode, ctx.stacked = mode, table.ndim == 3
        ctx.vocab, ctx.dtype = table.shape[-2], table.dtype
        return _embedding_bag(table, idx, mode)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        if ctx.stacked:
            grad = embedding_bag_backward(grad_out.contiguous(), idx, ctx.vocab, mode=ctx.mode)
        else:
            grad = embedding_bag_backward(grad_out[:, None, :].contiguous(),
                                          idx[:, None, :], ctx.vocab, mode=ctx.mode)[0]
        return grad.to(ctx.dtype), None, None


def _interaction(feats: torch.Tensor, *, packed: bool) -> torch.Tensor:
    if feats.ndim != 3:
        raise ValueError(f"expected feats (B, F, D), got {tuple(feats.shape)}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"feats dtype {feats.dtype} not supported (float32, bfloat16)")
    fake = is_fake(feats)
    if not feats.is_cuda and not fake:
        return ref.dot_interaction_packed(feats) if packed else ref.gram(feats)
    if feats.is_cuda:
        _require_contiguous("feats", feats)
    b, f, d = feats.shape
    n_out = f * (f - 1) // 2 if packed else f * f
    if fake:
        out = torch.empty((b, n_out), dtype=feats.dtype, device=feats.device)
        _account("dot_interaction", _ix.work(b, f, d, feats.element_size(), packed))
        return out
    plan = _ix.plan(b, f, d, feats.element_size(), packed, _ix.sm_count(feats.device.index))
    out = torch.empty((b, n_out), dtype=feats.dtype, device=feats.device)
    if out.numel():
        _ix.launch(feats, out, plan, packed=packed)
    return out


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F(F-1)/2): the strict lower triangle of each
    sample's Gram matrix in ``np.tril_indices(F, -1)`` order, float32
    accumulation, result in the input's dtype."""
    if isinstance(feats, DTensor):
        return _on_batch_shards(dot_interaction, (feats,))
    if _needs_grad(feats):
        return _DotInteraction.apply(feats)
    return _interaction(feats, packed=True)


def gram(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F·F) flattened Gram matrices."""
    _no_backward_kernel("gram", "dot_interaction has one", feats)
    return _interaction(feats, packed=False)


def dot_interaction_backward(grad: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """The input's gradient of ``dot_interaction``: grad (B, F(F-1)/2),
    feats (B, F, D) → (B, F, D) = (S + Sᵀ)·X, S the strict lower triangle
    of each sample scattered from grad; float32 accumulation, result in the
    features' dtype.  A CUDA tensor launches K2-bwd; a CPU tensor takes
    ``ref.dot_interaction_backward``."""
    if feats.ndim != 3 or grad.ndim != 2:
        raise ValueError(f"expected grad (B, P) and feats (B, F, D), got "
                         f"{tuple(grad.shape)}, {tuple(feats.shape)}")
    b, f, d = feats.shape
    if grad.shape != (b, f * (f - 1) // 2):
        raise ValueError(f"grad {tuple(grad.shape)} does not match feats {tuple(feats.shape)}")
    if feats.dtype not in _DTYPES or grad.dtype != feats.dtype:
        raise TypeError(f"grad and feats must share one dtype of float32/bfloat16, got "
                        f"{grad.dtype}, {feats.dtype}")
    if grad.device != feats.device:
        raise ValueError(f"grad lies on {grad.device}, feats on {feats.device}")
    fake = is_fake(feats)
    if not feats.is_cuda and not fake:
        return ref.dot_interaction_backward(grad, feats)
    if feats.is_cuda:
        _require_contiguous("grad", grad)
        _require_contiguous("feats", feats)
    if fake:
        _account("dot_interaction_backward", _ix.backward_work(b, f, d, feats.element_size()))
        return torch.empty_like(feats)
    plan = _ix.backward_plan(b, f, d, feats.element_size(), _ix.sm_count(feats.device.index))
    out = torch.empty_like(feats)
    if out.numel():
        _ix.launch_backward(grad, feats, out, plan)
    return out


class _DotInteraction(torch.autograd.Function):
    """K2 forward, K2-bwd backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return _interaction(feats, packed=True)

    @staticmethod
    def backward(ctx, grad):
        (feats,) = ctx.saved_tensors
        return dot_interaction_backward(grad.contiguous(), feats)


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One xDeepFM CIN layer: x0 (B, F, D), xk (B, H, D), w (H·F, Hn) →
    (B, Hn, D), ``out[b, n, d] = Σ_{h,f} w[h·F+f, n] · xk[b,h,d] · x0[b,f,d]``;
    float32 accumulation, result in the inputs' dtype.  Neither ``D`` nor
    the batch is padded."""
    if x0.ndim != 3 or xk.ndim != 3 or w.ndim != 2:
        raise ValueError(f"expected x0 (B, F, D), xk (B, H, D), w (H·F, Hn); got "
                         f"{tuple(x0.shape)}, {tuple(xk.shape)}, {tuple(w.shape)}")
    b, f, d = x0.shape
    h = xk.shape[1]
    if xk.shape[0] != b or xk.shape[2] != d:
        raise ValueError(f"xk {tuple(xk.shape)} does not share B and D with x0 {tuple(x0.shape)}")
    if f < 1 or h < 1:
        raise ValueError(f"a CIN layer needs at least one field and one map, got F={f}, H={h}")
    if w.shape[0] != h * f:
        raise ValueError(f"w has {w.shape[0]} rows, H·F = {h}·{f} = {h * f}")
    if x0.dtype not in _DTYPES or xk.dtype != x0.dtype or w.dtype != x0.dtype:
        raise TypeError(f"x0, xk, w must share one dtype of float32/bfloat16, got "
                        f"{x0.dtype}, {xk.dtype}, {w.dtype}")
    if xk.device != x0.device or w.device != x0.device:
        raise ValueError(f"x0 lies on {x0.device}, xk on {xk.device}, w on {w.device}")
    if any(isinstance(t, DTensor) for t in (x0, xk, w)):
        return _on_batch_shards(cin_layer, (x0, xk), (w,))
    if _needs_grad(x0, xk, w):
        return _CinLayer.apply(x0, xk, w)
    return _cin_layer(x0, xk, w)


def _cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    fake = is_fake(x0)
    if not x0.is_cuda and not fake:
        return ref.cin_layer(x0, xk, w)
    if x0.is_cuda:
        for name, t in (("x0", x0), ("xk", xk), ("w", w)):
            _require_contiguous(name, t)
    b, f, d = x0.shape
    h = xk.shape[1]
    out = torch.empty((b, w.shape[1], d), dtype=x0.dtype, device=x0.device)
    if fake:
        _account("cin_layer", _cin.work(b, f, h, w.shape[1], d, x0.element_size()))
    elif out.numel():
        _cin.launch(x0, xk, w, out)
    return out


def cin_layer_backward(g: torch.Tensor, x0: torch.Tensor, xk: torch.Tensor,
                       w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``cin_layer``: g = ∂L/∂out (B, Hn, D), x0 (B, F, D),
    xk (B, H, D), w (H·F, Hn) → (dx0, dxk, dw) in the inputs' dtype, every
    sum float32.  A CUDA tensor launches K3-bwd (the outer-product maps and
    ``w·g`` are never stored; the same bits every launch); a CPU tensor
    takes ``ref.cin_layer_backward``."""
    if g.ndim != 3 or x0.ndim != 3 or xk.ndim != 3 or w.ndim != 2:
        raise ValueError(f"expected g (B, Hn, D), x0 (B, F, D), xk (B, H, D), w (H·F, Hn); "
                         f"got {tuple(g.shape)}, {tuple(x0.shape)}, {tuple(xk.shape)}, "
                         f"{tuple(w.shape)}")
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    if (xk.shape[0], xk.shape[2]) != (b, d) or g.shape != (b, n, d) or w.shape[0] != h * f:
        raise ValueError(f"g {tuple(g.shape)}, x0 {tuple(x0.shape)}, xk {tuple(xk.shape)} "
                         f"and w {tuple(w.shape)} do not fit one CIN layer")
    if x0.dtype not in _DTYPES or any(t.dtype != x0.dtype for t in (g, xk, w)):
        raise TypeError(f"g, x0, xk, w must share one dtype of float32/bfloat16, got "
                        f"{g.dtype}, {x0.dtype}, {xk.dtype}, {w.dtype}")
    if any(t.device != x0.device for t in (g, xk, w)):
        raise ValueError(f"g lies on {g.device}, x0 on {x0.device}, xk on {xk.device}, "
                         f"w on {w.device}")
    fake = is_fake(x0)
    if not x0.is_cuda and not fake:
        return ref.cin_layer_backward(g, x0, xk, w)
    if x0.is_cuda:
        for name, t in (("g", g), ("x0", x0), ("xk", xk), ("w", w)):
            _require_contiguous(name, t)
    if b * d == 0 or n == 0:                        # nothing to sum: zeros, no launch
        return torch.zeros_like(x0), torch.zeros_like(xk), torch.zeros_like(w)
    plan = _cin.backward_plan(b, f, h, n, d)
    dx0, dxk, dw = torch.empty_like(x0), torch.empty_like(xk), torch.empty_like(w)
    scratch = {name: torch.empty(shape, dtype=dtype, device=x0.device)
               for name, (shape, dtype) in _cin.backward_scratch(plan, b, f, h, n, d).items()}
    if fake:
        _account("cin_layer_backward", _cin.backward_work(b, f, h, n, d, x0.element_size()))
    else:
        _cin.launch_backward(g, x0, xk, w, dx0, dxk, dw, plan=plan, scratch=scratch)
    return dx0, dxk, dw


class _CinLayer(torch.autograd.Function):
    """K3 forward, K3-bwd backward (plain versions for CPU tensors).  Where
    xk is x0 (a CIN's first layer) autograd adds the two gradients."""

    @staticmethod
    def forward(ctx, x0, xk, w):
        ctx.save_for_backward(x0, xk, w)
        return _cin_layer(x0, xk, w)

    @staticmethod
    def backward(ctx, grad):
        x0, xk, w = ctx.saved_tensors
        return cin_layer_backward(grad.contiguous(), x0, xk, w)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, return_lse: bool = False):
    """One query token per sequence against its KV cache: q (B, Hq, D),
    k/v (B, T, Hkv, D), pos (B,) → (B, Hq, D).  Query head ``h·G + g``
    (G = Hq / Hkv) reads KV head ``h``; slots ``t >= pos[b]`` are masked
    (all of them for ``pos <= 0``, which gives the mean of V).  float32
    inside, result in q's dtype.  With ``return_lse`` also each query
    head's log-sum-exp of its scaled scores over the valid slots, (B, Hq)
    float32, ``-inf`` where ``pos <= 0`` (the same launch writes it).
    ``pos`` is int32 on the GPU; the kernel takes D in ``HEAD_DIMS`` and G
    in ``GROUPS`` of ``kernels.decode_attention``.  DTensor caches go
    through ``_decode_on_shards``."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape or pos.ndim != 1:
        raise ValueError(f"expected q (B, Hq, D), k and v (B, T, Hkv, D), pos (B,); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(pos.shape)}")
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or pos.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and pos {tuple(pos.shape)} "
                         f"do not share B and D")
    if t < 1 or hkv < 1 or hq % hkv != 0:
        raise ValueError(f"need T >= 1 and Hq a multiple of Hkv, got T={t}, Hq={hq}, Hkv={hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"pos must be an integer tensor, got {pos.dtype}")
    if any(x.device != q.device for x in (k, v, pos)):
        raise ValueError(f"q lies on {q.device}, k on {k.device}, v on {v.device}, "
                         f"pos on {pos.device}")
    if isinstance(k, DTensor):
        return _decode_on_shards(q, k, v, pos, return_lse)
    _no_backward_kernel("decode_attention", "K4 serves decoding only", q, k, v)
    fake = is_fake(q)
    if not q.is_cuda and not fake:
        return ref.decode_attention(q, k, v, pos, return_lse=return_lse)
    if q.is_cuda:
        if pos.dtype != torch.int32:
            raise TypeError(f"pos must be int32 on the GPU, got {pos.dtype}")
        if d not in _da.HEAD_DIMS or hq // hkv not in _da.GROUPS:
            raise ValueError(f"the kernel takes D in {_da.HEAD_DIMS} and Hq/Hkv in "
                             f"{_da.GROUPS}, got D={d}, Hq/Hkv={hq // hkv}")
        for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos)):
            _require_contiguous(name, x)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    if fake:
        _account("decode_attention", _da.work(b, hq, hkv, d, t, q.element_size()))
    else:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        if b:
            _da.launch(q, k, v, pos, out, lse=lse)
    return (out, lse) if return_lse else out


def cache_split(cache_placements, heads_dim: int | None) -> tuple:
    """Per mesh axis, the placement of a tensor of a KV cache's sequences
    (q, a new K/V row, with their heads at dim ``heads_dim``; pos, None):
    split as the cache's batch (dim 0) and KV heads (dim 2) are, whole over
    an axis that splits the cache's slots (dim 1)."""
    for p in cache_placements:
        if not (p == Replicate() or p.is_shard(0) or p.is_shard(1) or p.is_shard(2)):
            raise ValueError(f"no decode for a cache placed {cache_placements}")
    return tuple(Shard(0) if p.is_shard(0) else
                 Shard(heads_dim) if p.is_shard(2) and heads_dim is not None else Replicate()
                 for p in cache_placements)


def first_slot(cache: DTensor) -> tuple[int | None, int]:
    """(the mesh axis that splits a DTensor cache (B, T, ...) over its
    slots, or None; the first slot this rank holds): rank r of m holds
    DTensor's shard of ⌈T / m⌉ slots from r·⌈T / m⌉."""
    axes = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    if len(axes) > 1:
        raise ValueError(f"the cache's slots are split over more than one axis: "
                         f"{cache.placements}")
    if not axes:
        return None, 0
    mesh = cache.device_mesh
    return axes[0], mesh.get_local_rank(axes[0]) * -(-cache.shape[1] // mesh.size(axes[0]))


def _decode_on_shards(q: torch.Tensor, k: DTensor, v: DTensor, pos: torch.Tensor,
                      return_lse: bool):
    """``decode_attention`` on DTensor caches (``distributed/sharding.py::
    lm_cache_pspecs``), each rank's kernel on its local tensors.  A mesh
    axis that splits the cache's batch (dim 0) splits q's and pos's too;
    one that splits its KV heads (dim 2) splits q's heads, and nothing is
    merged.  One that splits its slots (dim 1, the time split) holds q and
    pos whole on each of its ranks: rank r of m runs the kernel on its T_r
    slots at the local length ``clamp(pos − r·⌈T/m⌉, 0, T_r)``, with its
    log-sum-exp; the ranks' (out, lse) are gathered over the axis in rank
    order and merged (``ref.merge_decode_attention``, plain tensor code,
    float32 inside): the same bits on every run, never an all-reduce whose
    order the backend chooses.  The output is split as q's batch and heads
    are, replicated over the time axis."""
    mesh = k.device_mesh
    q_pl = cache_split(k.placements, 1)           # lse (B, Hq) is split as q (B, Hq, D)
    pos_pl = cache_split(k.placements, None)
    axis, lo = first_slot(k)
    q, pos = _as_dtensor(q, k), _as_dtensor(pos, k)
    if axis is None:
        return local_map(lambda q_, k_, v_, n_: decode_attention(q_, k_, v_, n_,
                                                                 return_lse=return_lse),
                         out_placements=(list(q_pl), list(q_pl)) if return_lse else list(q_pl),
                         in_placements=(q_pl, k.placements, v.placements, pos_pl),
                         device_mesh=mesh, redistribute_inputs=True)(q, k, v, pos)

    def local(q_, k_, v_, n_):
        n_ = (n_ - lo).clamp(0, k_.shape[1]).to(n_.dtype)
        out, lse = decode_attention(q_, k_, v_, n_, return_lse=True)
        return out[None], lse[None]

    # the ranks' results stacked on a new leading dim, split over the time axis
    stacked = tuple(Shard(0) if i == axis else p if p == Replicate() else Shard(p.dim + 1)
                    for i, p in enumerate(q_pl))
    outs, lses = local_map(local, out_placements=(list(stacked), list(stacked)),
                           in_placements=(q_pl, k.placements, v.placements, pos_pl),
                           device_mesh=mesh, redistribute_inputs=True)(q, k, v, pos)
    whole = tuple(Replicate() if i == axis else p for i, p in enumerate(stacked))
    out, lse = local_map(ref.merge_decode_attention, out_placements=(list(q_pl), list(q_pl)),
                         in_placements=(whole, whole), device_mesh=mesh,
                         redistribute_inputs=True)(outs, lses)
    return (out, lse) if return_lse else out
