"""The bilinear-fusion zoo (reference model/fusions/fusions.py:29-675).

The port's counterparts of the JAX package's ``models/fusions.py``: the
fusions of the reference's vendored ``block.bootstrap`` collection (only
``MFB`` is live in DualVGR, ``models/fusion.py``): MLP, ConcatMLP,
LinearSum, MLB, MFB (general form), MFH, Mutan, Tucker, Block,
BlockTucker and MCB, each with the reference's semantics, the quirk of
torch's ``F.normalize(z, p=2)`` default dim=1 in the power normalization
included. ``fusion_factory`` is the reference's registry (factory.py:14-42).

Every fusion takes its ``input_dims`` first, as the reference's do: torch
builds its parameters at construction, where flax infers the input sizes
at the first call (the JAX fusions have no such argument). MCB's count
sketches hold their hash and sign vectors as buffers drawn from a
``torch.Generator`` seeded with ``seed``; the JAX package draws them from a
JAX key, which torch cannot reproduce, so the weight bridge carries the JAX
values across. MCB's circular convolution is ``torch.fft.rfft`` /
``irfft`` and the sketch an ``index_add_``, on the input's device.
Submodules carry the flax names, Linears xavier_uniform with zero biases.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.models.init import dense, flax_init_
from dualvgr_tpu_torch.ops.dropout import Dropout


def get_sizes_list(dim: int, chunks: int):
    """Chunk sizes covering ``dim`` (reference fusions.py:5-17)."""
    split_size = (dim + chunks - 1) // chunks
    sizes_list = [split_size] * chunks
    sizes_list[-1] = sizes_list[-1] - (sum(sizes_list) - dim)
    assert sum(sizes_list) == dim
    if sizes_list[-1] < 0:
        n_miss = sizes_list[-2] - sizes_list[-1]
        sizes_list[-1] = sizes_list[-2]
        for j in range(n_miss):
            sizes_list[-j - 1] -= 1
        assert sum(sizes_list) == dim and min(sizes_list) > 0
    return sizes_list


def power_normalize(z):
    """Signed square root, then L2 normalization over dim 1 (torch's
    F.normalize default)."""
    z = torch.sqrt(F.relu(z)) - torch.sqrt(F.relu(-z))
    return z / torch.sqrt(torch.clamp((z * z).sum(dim=1, keepdim=True), min=1e-24))


def _activ(name):
    return getattr(F, name) if name else (lambda x: x)


def _xdense(in_dim, out_dim):
    return dense(in_dim, out_dim, init="xavier")


class MLP(nn.Module):
    """(reference fusions.py:29-53)."""

    def __init__(self, input_dim: int, dimensions: Sequence[int], activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.n, self.activation = len(dimensions), activation
        for i, dout in enumerate(dimensions):
            self.add_module(f"linear_{i}", _xdense(input_dim, dout))
            input_dim = dout
        self.drop = Dropout(dropout)

    def forward(self, x, generator=None):
        for i in range(self.n):
            x = getattr(self, f"linear_{i}")(x)
            if i < self.n - 1:
                x = self.drop(_activ(self.activation)(x), generator)
        return x


class ConcatMLP(nn.Module):
    """(reference fusions.py:645-675)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, dimensions: Sequence[int] = (500, 500),
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.mlp = MLP(sum(input_dims), tuple(dimensions) + (output_dim,), activation, dropout)

    def forward(self, x0, x1, generator=None):
        if x0.ndim == 3 and x1.ndim == 2:
            x1 = x1[:, None, :].expand(*x0.shape[:2], x1.shape[-1])
        if x1.ndim == 3 and x0.ndim == 2:
            x0 = x0[:, None, :].expand(*x1.shape[:2], x0.shape[-1])
        return self.mlp(torch.cat([x0, x1], dim=-1), generator)


class _TwoLinears(nn.Module):
    """linear0 and linear1 to ``mm_dim``, the output Linear, the three
    dropout sites of the reference's fusions."""

    def __init__(self, input_dims, output_dim, mm_dim, out_in, dropout_input, dropout_pre, dropout_output):
        super().__init__()
        self.linear0 = _xdense(input_dims[0], mm_dim)
        self.linear1 = _xdense(input_dims[1], mm_dim)
        self.linear_out = _xdense(out_in, output_dim)
        self.drop_input, self.drop_pre = Dropout(dropout_input), Dropout(dropout_pre)
        self.drop_output = Dropout(dropout_output)


class LinearSum(_TwoLinears):
    """(reference fusions.py:580-643)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 1200, activ_input: str = "relu",
                 activ_output: str = "relu", normalize: bool = False, dropout_input: float = 0.0,
                 dropout_pre_lin: float = 0.0, dropout_output: float = 0.0):
        super().__init__(input_dims, output_dim, mm_dim, mm_dim, dropout_input, dropout_pre_lin, dropout_output)
        self.activ_input, self.activ_output, self.normalize = activ_input, activ_output, normalize

    def _combine(self, x0, x1):
        return x0 + x1

    def forward(self, x0, x1, generator=None):
        act = _activ(self.activ_input)
        x0 = self.drop_input(act(self.linear0(x0)), generator)
        x1 = self.drop_input(act(self.linear1(x1)), generator)
        z = self._combine(x0, x1)
        if self.normalize:
            z = power_normalize(z)
        z = _activ(self.activ_output)(self.linear_out(self.drop_pre(z, generator)))
        return self.drop_output(z, generator)


class MLB(LinearSum):
    """Multimodal low-rank bilinear pooling (reference fusions.py:330-380)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 256, **kw):
        super().__init__(input_dims, output_dim, mm_dim, **kw)

    def _combine(self, x0, x1):
        return x0 * x1


class GeneralMFB(_TwoLinears):
    """Full-option MFB (reference fusions.py:382-453); the model's own
    instance is ``models/fusion.py::MFB``."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 256, factor: int = 2,
                 activ_input: str = "elu", activ_output: str = "elu", normalize: bool = False,
                 dropout_input: float = 0.0, dropout_pre_norm: float = 0.0, dropout_output: float = 0.0):
        super().__init__(input_dims, output_dim, mm_dim * factor, mm_dim, dropout_input,
                         dropout_pre_norm, dropout_output)
        self.mm_dim, self.factor = mm_dim, factor
        self.activ_input, self.activ_output, self.normalize = activ_input, activ_output, normalize

    def forward(self, x0, x1, generator=None):
        act = _activ(self.activ_input)
        x0 = self.drop_input(act(self.linear0(x0)), generator)
        x1 = self.drop_input(act(self.linear1(x1)), generator)
        z = self.drop_pre(x0 * x1, generator)
        z = z.view(*z.shape[:-1], self.mm_dim, self.factor).sum(-1)
        if self.normalize:
            z = power_normalize(z)
        return _activ(self.activ_output)(self.linear_out(z))


class MFH(nn.Module):
    """Two-stage factorized high-order pooling (reference fusions.py:455-540)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 128, factor: int = 2,
                 activ_input: str = "relu", activ_output: str = "relu", normalize: bool = False,
                 dropout_input: float = 0.0, dropout_pre_lin: float = 0.0, dropout_output: float = 0.0):
        super().__init__()
        self.mm_dim, self.factor = mm_dim, factor
        self.activ_input, self.activ_output, self.normalize = activ_input, activ_output, normalize
        for stage in (0, 1):
            self.add_module(f"linear0_{stage}", _xdense(input_dims[0], mm_dim * factor))
            self.add_module(f"linear1_{stage}", _xdense(input_dims[1], mm_dim * factor))
        self.linear_out = _xdense(2 * mm_dim, output_dim)
        self.drop_input, self.drop_pre = Dropout(dropout_input), Dropout(dropout_pre_lin)
        self.drop_output = Dropout(dropout_output)

    def forward(self, x0_in, x1_in, generator=None):
        act = _activ(self.activ_input)
        zs, skip = [], None
        for stage in (0, 1):
            x0 = self.drop_input(act(getattr(self, f"linear0_{stage}")(x0_in)), generator)
            x1 = self.drop_input(act(getattr(self, f"linear1_{stage}")(x1_in)), generator)
            m = x0 * x1 if skip is None else x0 * x1 * skip
            m = self.drop_pre(m, generator)
            skip = m
            z = m.view(*m.shape[:-1], self.mm_dim, self.factor).sum(-1)
            zs.append(power_normalize(z) if self.normalize else z)
        z = _activ(self.activ_output)(self.linear_out(torch.cat(zs, dim=-1)))
        return self.drop_output(z, generator)


class Mutan(nn.Module):
    """Rank-constrained Tucker fusion (reference fusions.py:205-269)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 1600, rank: int = 15,
                 shared: bool = False, normalize: bool = False, dropout_input: float = 0.0,
                 dropout_pre_lin: float = 0.0, dropout_output: float = 0.0):
        super().__init__()
        self.mm_dim, self.rank, self.shared, self.normalize = mm_dim, rank, shared, normalize
        self.linear0 = _xdense(input_dims[0], mm_dim)
        self.merge_linear0 = _xdense(mm_dim, mm_dim * rank)
        if not shared:  # shared: linear0 and merge_linear0 serve both inputs
            self.linear1 = _xdense(input_dims[1], mm_dim)
            self.merge_linear1 = _xdense(mm_dim, mm_dim * rank)
        self.linear_out = _xdense(mm_dim, output_dim)
        self.drop_input, self.drop_pre = Dropout(dropout_input), Dropout(dropout_pre_lin)
        self.drop_output = Dropout(dropout_output)

    def forward(self, x0, x1, generator=None):
        lin1, merge1 = (self.linear0, self.merge_linear0) if self.shared else (self.linear1, self.merge_linear1)
        x0 = self.drop_input(self.linear0(x0), generator)
        x1 = self.drop_input(lin1(x1), generator)
        m = self.merge_linear0(x0) * merge1(x1)
        z = m.view(*m.shape[:-1], self.rank, self.mm_dim).sum(-2)
        if self.normalize:
            z = power_normalize(z)
        z = self.linear_out(self.drop_pre(z, generator))
        return self.drop_output(z, generator)


def _bilinear(in0: int, in1: int, out: int) -> nn.Bilinear:
    """torch's nn.Bilinear (weight (out, in0, in1)) with the JAX package's
    xavier_uniform on that shape (fans in0 * out and in1 * out) and a zero
    bias."""
    b = nn.Bilinear(in0, in1, out)
    flax_init_(b.weight, "xavier", in0 * out, in1 * out)
    nn.init.zeros_(b.bias)
    return b


class Tucker(nn.Module):
    """Full bilinear core (reference fusions.py:272-327)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 1600, shared: bool = False,
                 normalize: bool = False, dropout_input: float = 0.0, dropout_pre_lin: float = 0.0,
                 dropout_output: float = 0.0):
        super().__init__()
        self.normalize = normalize
        self.linear0 = _xdense(input_dims[0], mm_dim)
        self.linear1 = _xdense(input_dims[1], mm_dim)
        self.bilinear = _bilinear(mm_dim, mm_dim, mm_dim)
        self.linear_out = _xdense(mm_dim, output_dim)
        self.drop_input, self.drop_pre = Dropout(dropout_input), Dropout(dropout_pre_lin)
        self.drop_output = Dropout(dropout_output)

    def forward(self, x0, x1, generator=None):
        x0 = self.drop_input(self.linear0(x0), generator)
        x1 = self.drop_input(self.linear1(x1), generator)
        z = self.bilinear(x0, x1)
        if self.normalize:
            z = power_normalize(z)
        z = self.linear_out(self.drop_pre(z, generator))
        return self.drop_output(z, generator)


class _Chunked(nn.Module):
    """Shared body of Block and BlockTucker: linear0 (and linear1 unless
    ``shared``) to ``mm_dim``, the chunks' fusions by ``_chunk``, the power
    normalization before or after the concatenation, the output Linear."""

    def __init__(self, input_dims, output_dim, mm_dim, chunks, shared, dropout_input, dropout_pre_lin,
                 dropout_output, pos_norm):
        super().__init__()
        assert pos_norm in ("before_cat", "after_cat")
        self.shared, self.pos_norm = shared, pos_norm
        self.sizes = get_sizes_list(mm_dim, chunks)
        self.linear0 = _xdense(input_dims[0], mm_dim)
        if not shared:
            self.linear1 = _xdense(input_dims[1], mm_dim)
        self.linear_out = _xdense(mm_dim, output_dim)
        self.drop_input, self.drop_pre = Dropout(dropout_input), Dropout(dropout_pre_lin)
        self.drop_output = Dropout(dropout_output)

    def forward(self, x0, x1, generator=None):
        x0 = self.drop_input(self.linear0(x0), generator)
        x1 = self.drop_input((self.linear0 if self.shared else self.linear1)(x1), generator)
        zs, begin = [], 0
        for idx, size in enumerate(self.sizes):
            z = self._chunk(idx, x0[..., begin : begin + size], x1[..., begin : begin + size])
            begin += size
            zs.append(power_normalize(z) if self.pos_norm == "before_cat" else z)
        z = torch.cat(zs, dim=-1)
        if self.pos_norm == "after_cat":
            z = power_normalize(z)
        z = self.linear_out(self.drop_pre(z, generator))
        return self.drop_output(z, generator)


class Block(_Chunked):
    """Block-superdiagonal bilinear fusion (reference fusions.py:56-134)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 1600, chunks: int = 20,
                 rank: int = 15, shared: bool = False, dropout_input: float = 0.0, dropout_pre_lin: float = 0.0,
                 dropout_output: float = 0.0, pos_norm: str = "before_cat"):
        super().__init__(input_dims, output_dim, mm_dim, chunks, shared, dropout_input, dropout_pre_lin,
                         dropout_output, pos_norm)
        self.rank = rank
        for idx, size in enumerate(self.sizes):
            self.add_module(f"merge0_{idx}", _xdense(size, size * rank))
            if not shared:
                self.add_module(f"merge1_{idx}", _xdense(size, size * rank))

    def _chunk(self, idx, x0, x1):
        m0 = getattr(self, f"merge0_{idx}")
        m1 = m0 if self.shared else getattr(self, f"merge1_{idx}")
        m = m0(x0) * m1(x1)
        return m.view(*m.shape[:-1], self.rank, x0.shape[-1]).sum(-2)


class BlockTucker(_Chunked):
    """Block-diagonal Tucker fusion (reference fusions.py:137-202)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 1600, chunks: int = 20,
                 shared: bool = False, dropout_input: float = 0.0, dropout_pre_lin: float = 0.0,
                 dropout_output: float = 0.0, pos_norm: str = "before_cat"):
        super().__init__(input_dims, output_dim, mm_dim, chunks, shared, dropout_input, dropout_pre_lin,
                         dropout_output, pos_norm)
        for idx, size in enumerate(self.sizes):
            self.add_module(f"bilinear_{idx}", _bilinear(size, size, size))

    def _chunk(self, idx, x0, x1):
        return getattr(self, f"bilinear_{idx}")(x0, x1)


class CountSketch(nn.Module):
    """Count sketch with fixed hash and sign vectors (reference
    compactbilinearpooling.py:60-120): buffers ``h`` (input_size,) int64 in
    [0, output_size) and ``s`` (input_size,) of +-1, drawn from a
    generator seeded with ``seed``."""

    def __init__(self, input_size: int, output_size: int, seed: int = 0):
        super().__init__()
        self.output_size = output_size
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("h", torch.randint(0, output_size, (input_size,), generator=gen))
        self.register_buffer("s", torch.randint(0, 2, (input_size,), generator=gen).float() * 2.0 - 1.0)

    def forward(self, x):
        out = x.new_zeros(*x.shape[:-1], self.output_size)
        return out.index_add_(-1, self.h, x * self.s)


class MCB(nn.Module):
    """Compact bilinear pooling: count sketches and their circular
    convolution by FFT (reference fusions.py:543-577)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, mm_dim: int = 16000,
                 activ_output: str = "relu", dropout_output: float = 0.0, seed: int = 0):
        super().__init__()
        self.mm_dim, self.activ_output = mm_dim, activ_output
        self.sketch0 = CountSketch(input_dims[0], mm_dim, seed=seed)
        self.sketch1 = CountSketch(input_dims[1], mm_dim, seed=seed + 1)
        self.linear_out = _xdense(mm_dim, output_dim)
        self.drop_output = Dropout(dropout_output)

    def forward(self, x0, x1, generator=None):
        f0 = torch.fft.rfft(self.sketch0(x0), dim=-1)
        f1 = torch.fft.rfft(self.sketch1(x1), dim=-1)
        z = torch.fft.irfft(f0 * f1, n=self.mm_dim, dim=-1)
        z = _activ(self.activ_output)(self.linear_out(z))
        return self.drop_output(z, generator)


FUSIONS = {
    "block": Block,
    "block_tucker": BlockTucker,
    "mutan": Mutan,
    "tucker": Tucker,
    "mlb": MLB,
    "mfb": GeneralMFB,
    "mfh": MFH,
    "mcb": MCB,
    "linear_sum": LinearSum,
    "cat_mlp": ConcatMLP,
}


def fusion_factory(name: str, **kwargs):
    """Fusion registry (reference model/fusions/factory.py:14-42)."""
    if name not in FUSIONS:
        raise ValueError(f"unknown fusion {name!r}; available: {sorted(FUSIONS)}")
    return FUSIONS[name](**kwargs)
