"""Trainable layers with flax's parameter layout, names and numerics, for the
trainable twins of the mask nets (``models.trainable``, ``models.blstm``,
``models.qcnn``).

Every layer keeps its weights as ``nn.Parameter``s named as the flax module
names them (``kernel``, ``bias``, ``scale``, ``pos_emb``), shaped as flax
shapes them (a conv kernel (kh, kw, Cin, Cout), a dense kernel (In, Out)),
and a module tree whose attribute names are flax's auto-names
(``DoubleConv_0``, ``ConvBNRelu_1``, ``BatchNorm_0``, ...), so
:meth:`FlaxTree.variables` is the nested ``params`` / ``batch_stats`` dict
of a flax model and :meth:`FlaxTree.load_variables` reads one back.

Where the plain PyTorch idiom gives another model, the flax semantics are
kept:

  * BatchNorm: momentum 0.99, eps 1e-5; batch statistics by the fast
    variance E[x^2] - E[x]^2 clipped at 0, and that biased variance (not
    the unbiased one of ``nn.BatchNorm2d``) into the running ``var``. The
    running statistics are not touched by the forward: it leaves the batch's
    statistics in ``pending`` and :func:`commit_batch_stats` applies them
    once per step, so a rematerialised forward does not update them twice.
    Inside :func:`sync_batch_stats` the per-channel sums are all-reduced over
    the shards of a data-parallel step (global statistics, as the
    reference's sharded ``jit`` takes them).
  * LayerNorm: eps 1e-6, the fast variance.
  * The 3x3 (and any odd or (1, k)) SAME convs are im2col and one float32
    matrix product, as ``unet.FConv`` serves them (cuDNN's conv2d strayed
    over 1e-5 from the CPU on the card), in an autograd function that keeps
    only the conv's input and the kernel for the backward and rebuilds the
    columns there: the im2col tensors of a batch-16 DeepFPU step would
    otherwise be kept for the backward, several GB.
  * Init follows flax's distributions, drawn from an explicit CPU
    ``torch.Generator``: ``lecun_normal`` is a truncated normal in [-2, 2]
    whose std is divided by 0.87962566103423978, biases zero, BatchNorm
    scale one, the LSTM's recurrent kernels orthogonal. The numbers differ
    from JAX's for the same seed, by design.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
from torch import nn

__all__ = [
    "FlaxTree", "Conv", "ConvTranspose1x2", "Dense", "BatchNorm", "LayerNorm", "LSTMCell",
    "MultiHeadAttention", "FreqAttention", "commit_batch_stats", "sync_batch_stats", "current_sync",
    "pool_time", "lecun_normal_", "truncated_normal_", "conv_same",
]

BN_MOMENTUM = 0.99
BN_EPS = 1e-5
LN_EPS = 1e-6
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]
_GEMM_ELEMENTS = 1 << 28  # im2col floats per matrix product (1 GiB), as unet.FConv


# -- init ---------------------------------------------------------------------


def truncated_normal_(t: torch.Tensor, g: torch.Generator, std: float) -> None:
    """jax ``variance_scaling(..., "truncated_normal")``: a standard normal
    truncated to [-2, 2], times std / 0.87962566103423978."""
    cpu = torch.empty(t.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, 0.0, 1.0, -2.0, 2.0, generator=g)
    with torch.no_grad():
        t.copy_(cpu * (std / _TRUNC_STD))


def lecun_normal_(t: torch.Tensor, g: torch.Generator, fan_in: int, scale: float = 1.0) -> None:
    truncated_normal_(t, g, math.sqrt(scale / fan_in))


def _orthogonal_(t: torch.Tensor, g: torch.Generator) -> None:
    cpu = torch.empty(t.shape, dtype=torch.float32)
    nn.init.orthogonal_(cpu, generator=g)
    with torch.no_grad():
        t.copy_(cpu)


# -- the variables tree ---------------------------------------------------------


def _put(tree: dict, path: list[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get(tree: dict, path: list[str]):
    for p in path:
        tree = tree[p]
    return tree


class FlaxTree(nn.Module):
    """A module tree named as the flax model's: ``variables()`` gives the
    flax-shaped ``{"params": ..., "batch_stats": ...}`` dict of float32 numpy
    arrays (no ``batch_stats`` without a BatchNorm), ``load_variables`` copies
    one in, and ``reset_parameters(g)``
    draws every leaf's init in registration order."""

    def variables(self) -> dict:
        params, stats = {}, {}
        for name, p in self.named_parameters():
            _put(params, name.split("."), p.detach().cpu().numpy().copy())
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                path = name.split(".") if name else []
                for leaf in ("mean", "var"):
                    _put(stats, path + [leaf], getattr(m, leaf).detach().cpu().numpy().copy())
        return {"params": params, "batch_stats": stats} if stats else {"params": params}

    def load_variables(self, variables: dict) -> "FlaxTree":
        """Copy a flax variables tree (nested dicts of arrays) in; every
        parameter and BatchNorm statistic must be there, shaped alike."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                src = np.asarray(_get(variables["params"], name.split(".")), dtype=np.float32)
                if src.shape != tuple(p.shape):
                    raise ValueError(f"{name}: {src.shape} does not fit {tuple(p.shape)}")
                p.copy_(torch.from_numpy(src.copy()))
            for name, m in self.named_modules():
                if isinstance(m, BatchNorm):
                    node = _get(variables.get("batch_stats", {}), name.split(".") if name else [])
                    for leaf in ("mean", "var"):
                        getattr(m, leaf).copy_(torch.from_numpy(
                            np.asarray(node[leaf], dtype=np.float32).copy()))
        return self

    def reset_parameters(self, g: torch.Generator) -> "FlaxTree":
        for m in self.modules():
            if hasattr(m, "reset"):
                m.reset(g)
        return self


# -- data-parallel batch statistics ----------------------------------------------

_SYNC = threading.local()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the shards of a step, forward and backward (each shard's
    sum feeds its own loss term, so the gradient is the sum of theirs)."""

    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return coll.sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.sum(g.contiguous()), None


@contextlib.contextmanager
def sync_batch_stats(coll):
    """Inside, BatchNorm in training takes its statistics over every shard
    of ``coll`` (an object with ``sum(tensor) -> tensor`` over the shards
    and ``row_ratio``, the global over the local batch rows)."""
    prev = getattr(_SYNC, "coll", None)
    _SYNC.coll = coll
    try:
        yield
    finally:
        _SYNC.coll = prev


def current_sync():
    """The collective of the enclosing :func:`sync_batch_stats` in this
    thread, or None."""
    return getattr(_SYNC, "coll", None)


def _moments(x: torch.Tensor, dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) over ``dims``, over every shard inside sync_batch_stats."""
    coll = getattr(_SYNC, "coll", None)
    if coll is None:
        return x.mean(dims), (x * x).mean(dims)
    n = math.prod(x.shape[d] for d in dims) * coll.row_ratio
    s = _AllReduceSum.apply(torch.stack([x.sum(dims), (x * x).sum(dims)]), coll)
    return s[0] / n, s[1] / n


# -- layers -------------------------------------------------------------------


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (see the module docstring)."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        self.pending = None

    def reset(self, g) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mu, mu2 = _moments(x, tuple(range(x.ndim - 1)))
            var = torch.clamp(mu2 - mu * mu, min=0.0)
            self.pending = (mu.detach(), var.detach())
        else:
            mu, var = self.mean, self.var
        return (x - mu) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias


def commit_batch_stats(model: nn.Module) -> None:
    """Fold each BatchNorm's pending batch statistics into its running ones,
    once: running = 0.99 running + (1 - 0.99) batch."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.pending is not None:
                mu, var = m.pending
                m.mean.copy_(BN_MOMENTUM * m.mean + (1.0 - BN_MOMENTUM) * mu)
                m.var.copy_(BN_MOMENTUM * m.var + (1.0 - BN_MOMENTUM) * var)
                m.pending = None


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, fast variance."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def reset(self, g) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (x - mu) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (In, Out) lecun-normal, bias zero."""

    def __init__(self, n_in: int, n_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None

    def reset(self, g) -> None:
        lecun_normal_(self.kernel, g, self.kernel.shape[0])
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


def _same_pads(kh: int, kw: int) -> tuple[int, ...]:
    """F.pad widths of flax's SAME padding for a (kh, kw) kernel on (B, F, T, C)."""
    return (0, 0, (kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)


def _columns(xp: torch.Tensor, F: int, T: int, kh: int, kw: int) -> torch.Tensor:
    return torch.cat([xp[:, dy:dy + F, dx:dx + T] for dy in range(kh) for dx in range(kw)],
                     dim=-1)


def _batch_step(B: int, per_row: int) -> int:
    return max(1, min(B, _GEMM_ELEMENTS // max(per_row, 1)))


class _ConvIm2col(torch.autograd.Function):
    """SAME stride-1 conv of x (B, F, T, C) with w (kh kw C, Cout), tap-major:
    im2col and one float32 product per slice of the batch. Only x and w are
    kept for the backward; the columns are rebuilt there."""

    @staticmethod
    def forward(ctx, x, w, kh, kw):
        ctx.save_for_backward(x, w)
        ctx.kk = (kh, kw)
        B, F, T, C = x.shape
        xp = nn.functional.pad(x, _same_pads(kh, kw))
        step = _batch_step(B, F * T * kh * kw * C)
        return torch.cat([torch.matmul(_columns(xp[b:b + step], F, T, kh, kw), w)
                          for b in range(0, B, step)])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kh, kw = ctx.kk
        B, F, T, C = x.shape
        cout = w.shape[1]
        pads = _same_pads(kh, kw)
        xp = nn.functional.pad(x, pads)
        gx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        step = _batch_step(B, F * T * kh * kw * C)
        for b in range(0, B, step):
            gs = g[b:b + step].reshape(-1, cout)
            if gw is not None:
                cols = _columns(xp[b:b + step], F, T, kh, kw).reshape(-1, kh * kw * C)
                gw += torch.matmul(cols.t(), gs)
            if gx is not None:
                n = min(step, B - b)
                gc = torch.matmul(gs, w.t()).reshape(n, F, T, kh * kw, C)
                gp = x.new_zeros((n, F + kh - 1, T + kw - 1, C))
                for tap in range(kh * kw):
                    dy, dx = divmod(tap, kw)
                    gp[:, dy:dy + F, dx:dx + T] += gc[..., tap, :]
                gx[b:b + step] = gp[:, pads[4]:pads[4] + F, pads[2]:pads[2] + T]
        return gx, gw, None, None


def conv_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` without its bias: x (B, F, T, Cin),
    kernel (kh, kw, Cin, Cout)."""
    kh, kw, cin, cout = kernel.shape
    if kh == kw == 1:
        return torch.matmul(x, kernel.reshape(cin, cout))
    return _ConvIm2col.apply(x, kernel.reshape(kh * kw * cin, cout), kh, kw)


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (kh, kw), padding="SAME")``: kernel (kh, kw, Cin,
    Cout) lecun-normal (fan-in kh kw Cin), bias zero."""

    def __init__(self, cin: int, cout: int, kh: int = 3, kw: int = 3):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.kernel = nn.Parameter(torch.zeros(kh, kw, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset(self, g) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, g, kh * kw * cin)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.kernel) + self.bias


class ConvTranspose1x2(nn.Module):
    """flax ``nn.ConvTranspose(cout, (1, 2), strides=(1, 2))`` on (B, F, T,
    C): frame 2t gets x[t] @ W1 and frame 2t+1 x[t] @ W0 (flax does not flip
    the kernel; ``unet.ConvTranspose1x2`` serves it the same way)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cout = cout
        self.kernel = nn.Parameter(torch.zeros(1, 2, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset(self, g) -> None:
        lecun_normal_(self.kernel, g, 2 * self.kernel.shape[2])
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, T, _ = x.shape
        w = torch.cat([self.kernel[0, 1], self.kernel[0, 0]], dim=1)
        y = torch.matmul(x, w).reshape(B, F, T, 2, self.cout).reshape(B, F, 2 * T, self.cout)
        return y + self.bias


def pool_time(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((1, 2), strides=(1, 2))`` on (B, F, T, C) with XLA's
    gradient: a tie sends the gradient to the first frame of the pair (a
    ``torch.amax`` would split it)."""
    a, b = x[:, :, 0::2], x[:, :, 1::2]
    return torch.where(b > a, b, a)


class _Kernel(nn.Module):
    """One of OptimizedLSTMCell's named kernels (with or without bias)."""

    def __init__(self, n_in: int, hidden: int, use_bias: bool, recurrent: bool):
        super().__init__()
        self.recurrent = recurrent
        self.kernel = nn.Parameter(torch.zeros(n_in, hidden))
        self.bias = nn.Parameter(torch.zeros(hidden)) if use_bias else None

    def reset(self, g) -> None:
        if self.recurrent:
            _orthogonal_(self.kernel, g)
        else:
            lecun_normal_(self.kernel, g, self.kernel.shape[0])
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: input kernels ``ii if ig io`` (no bias,
    lecun-normal), hidden kernels ``hi hf hg ho`` (bias, orthogonal); gates
    i, f, g, o. :meth:`scan` runs it over a sequence from zero carries."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in "ifgo":
            self.add_module("i" + gate, _Kernel(n_in, hidden, False, False))
            self.add_module("h" + gate, _Kernel(hidden, hidden, True, True))

    def _stacked(self):
        get = lambda name: getattr(self, name)  # noqa: E731 - "if" is a keyword
        wi = torch.cat([get("i" + g).kernel for g in "ifgo"], dim=1)
        wh = torch.cat([get("h" + g).kernel for g in "ifgo"], dim=1)
        bh = torch.cat([get("h" + g).bias for g in "ifgo"])
        return wi, wh, bh

    def scan(self, seq: torch.Tensor, carry=None, reverse: bool = False):
        """seq (B, T, In) -> (outputs (B, T, H), the last carry (c, h));
        ``reverse`` runs from the last frame and keeps the outputs in order
        (flax ``nn.RNN(reverse=True, keep_order=True)``)."""
        H = self.hidden
        wi, wh, bh = self._stacked()
        xi = torch.matmul(seq, wi)
        if carry is None:
            z0 = seq.new_zeros((seq.shape[0], H))
            carry = (z0, z0)
        c, h = carry
        T = seq.shape[1]
        outs = [None] * T
        for t in (reversed(range(T)) if reverse else range(T)):
            z = (torch.matmul(h, wh) + bh) + xi[:, t]
            i, f = torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H])
            gg, o = torch.tanh(z[:, 2 * H:3 * H]), torch.sigmoid(z[:, 3 * H:])
            c = f * c + i * gg
            h = o * torch.tanh(c)
            outs[t] = h
        return torch.stack(outs, dim=1), (c, h)


class _DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` of the attention: kernel (C, heads, D) in or
    (heads, D, C) out, with bias; fan-in C or heads D (flax initialises the
    flattened kernel)."""

    def __init__(self, shape: tuple, bias_shape: tuple, fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def reset(self, g) -> None:
        lecun_normal_(self.kernel, g, self.fan_in)
        with torch.no_grad():
            self.bias.zero_()


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, deterministic):
    query/key/value kernels (C, heads, C / heads) with biases, logits scaled
    by 1/sqrt(head_dim), softmax, out kernel (heads, head_dim, C) with bias;
    plain matrix products."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        d = ch // heads
        self.heads, self.head_dim = heads, d
        for name in ("query", "key", "value"):
            self.add_module(name, _DenseGeneral((ch, heads, d), (heads, d), ch))
        self.out = _DenseGeneral((heads, d, ch), (ch,), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C, H, D = x.shape[-1], self.heads, self.head_dim

        def proj(m):
            y = torch.matmul(x, m.kernel.reshape(C, H * D)) + m.bias.reshape(H * D)
            return y.reshape(*x.shape[:-1], H, D).transpose(-3, -2)  # (..., H, L, D)

        q = proj(self.query) / math.sqrt(D)
        k, v = proj(self.key), proj(self.value)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        o = torch.matmul(w, v).transpose(-3, -2)  # (..., L, H, D)
        return torch.matmul(o.reshape(*o.shape[:-2], H * D),
                            self.out.kernel.reshape(H * D, C)) + self.out.bias


class FreqAttention(FlaxTree):
    """TPUFPU's frequency-axis transformer block (azoom.models.unet.
    FreqAttention) on (B, Fp, T, C): pre-LN self-attention over the Fp
    folded-frequency rows of each frame with a learned position embedding
    (normal, std 0.02), then a 2x MLP with flax's tanh-approximate gelu, both
    residual. Float32 matrix products in the int8 nets too."""

    def __init__(self, fp: int, ch: int, heads: int):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.zeros(fp, ch))
        self.LayerNorm_0 = LayerNorm(ch)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(ch, heads)
        self.LayerNorm_1 = LayerNorm(ch)
        self.Dense_0 = Dense(ch, 2 * ch)
        self.Dense_1 = Dense(2 * ch, ch)

    def reset(self, g) -> None:
        cpu = torch.empty(self.pos_emb.shape)
        cpu.normal_(0.0, 0.02, generator=g)
        with torch.no_grad():
            self.pos_emb.copy_(cpu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(-3, -2)  # (B, T, Fp, C)
        a = self.LayerNorm_0(h) + self.pos_emb
        h = h + self.MultiHeadDotProductAttention_0(a)
        m = self.Dense_1(nn.functional.gelu(self.Dense_0(self.LayerNorm_1(h)), approximate="tanh"))
        return (h + m).transpose(-3, -2)
