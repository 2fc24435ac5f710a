"""Python side of csrc/gemm_nn.cu (the pipelined GEMM core: NN products,
`gemm_nn`, and K-split TN products, `gemm_tn`, with their plain versions
`gemm_nn_plain` and `gemm_tn_plain`) and csrc/gemm.cu (`sum_splits`, the
fixed-order reduction of split-K partials): one launch per call, on CUDA
tensors only and outside autograd.

Matrices are row-major with a row stride (`ld*`) and unit column stride;
the kernels round both operands to the compute dtype as they load them and
accumulate in float32.
"""

from __future__ import annotations

import math
import struct

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build

# K rows per split of a long TN reduction (a weight gradient over every
# slice and node, or every step and row) where the caller sets none.
SPLIT_ROWS = 256


def sum_splits(part: torch.Tensor, out: torch.Tensor, what: str) -> None:
    """out [M, N] (row stride out.stride(0)) = part [S, M, N] summed over S
    in order; each split's [M, N] contiguous, the splits part.stride(0)
    apart (the first M rows of larger partials)."""
    splits, m, n = part.shape
    if part.stride(2) != 1 or (m > 1 and part.stride(1) != n):
        raise ValueError(f"{what}: each split's partial must be contiguous, got strides "
                         f"{part.stride()}")
    cuda_build.check(
        cuda_build.load().wf_sum_splits(
            part.data_ptr(), splits, part.stride(0), out.data_ptr(), m, n, out.stride(0),
            cuda_build.stream_ptr(out.device),
        ),
        what,
    )


def sum_splits_plain(part: torch.Tensor, out: torch.Tensor, what: str = "") -> None:
    """Plain version of `sum_splits`: out = part summed over its first axis."""
    out.copy_(part.sum(dim=0))


# gemm_nn's launch arguments, packed as csrc/gemm_nn.cu's `NNLaunch`: 25
# 8-byte integers (pointers as integers), the scale as a double, 8 more.
_NN_LAUNCH = struct.Struct("<25qd8q")
# gemm_tn's, as `TNLaunch`: 18 8-byte integers.
_TN_LAUNCH = struct.Struct("<18q")
# gemm_nn's epilogues (csrc/gemm_nn.cu `wf::Epilogue`).
EPILOGUES = {"none": 0, "bias_relu": 1, "gates": 2, "mask": 3, "bias_relu_mask": 4,
             "relu_grad": 5}
NN_MULTIPLE = 8  # K, N, row strides and batch strides: multiples of 8 elements
NN_ROW_TILE = 128  # output rows a block of the core: the relu_grad column sums' tile


def row_tiles(rows: int) -> int:
    """The core's row tiles over `rows` output rows (relu_grad's partials)."""
    return -(-rows // NN_ROW_TILE)


def _epilogue(y, epilogue, bias, mask, scale, residual):
    if epilogue == "bias_relu":
        return torch.relu(y + bias)
    if epilogue == "bias_relu_mask":
        return torch.relu(y + bias) * (mask.to(y.dtype) * scale)
    if epilogue == "gates":  # gate order i, f, g, o
        i, f, g, o = (y + bias).chunk(4, dim=-1)
        return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)],
                         dim=-1)
    if epilogue == "mask":
        return y * (mask.to(y.dtype) * scale)
    if epilogue == "relu_grad":
        y = y * (residual.to(y.dtype) > 0).to(y.dtype)
        return y if mask is None else y * (mask.to(y.dtype) * scale)
    if epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y


def tile_colsums(y: torch.Tensor) -> torch.Tensor:
    """[..., M, N] -> [prod(...) * row_tiles(M), N]: the column sums of each
    NN_ROW_TILE-row tile of each batch entry (the relu_grad partials)."""
    m, n = y.shape[-2:]
    tiles = row_tiles(m)
    y = y.reshape(-1, m, n)
    if tiles * NN_ROW_TILE != m:
        y = torch.cat([y, y.new_zeros((y.shape[0], tiles * NN_ROW_TILE - m, n))], dim=1)
    return y.reshape(-1, tiles, NN_ROW_TILE, n).sum(dim=2).reshape(-1, n)


def gemm_nn_plain(
    a: torch.Tensor, b: torch.Tensor, *, compute_dtype: torch.dtype,
    a2: torch.Tensor | None = None, b2: torch.Tensor | None = None, row_offset: int = 0,
    epilogue: str = "none", bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, scale: float = 1.0,
    residual: torch.Tensor | None = None, colsum: torch.Tensor | None = None,
    out: torch.Tensor | None = None, out_dtype: torch.dtype | None = None, what: str = "",
) -> torch.Tensor:
    """Plain version of `gemm_nn`, the same rounding points: round(a) @
    round(b) in the accumulation dtype, plus round(a2) @ round(b2) on the
    output rows from `row_offset` on, then the epilogue (relu_grad also
    writes its tiles' column sums into `colsum`), stored in `out_dtype`
    (default: the accumulation dtype) or into `out`. `what` (gemm_nn's label
    for its errors) keeps the two signatures one."""
    y = torch.matmul(as_operand(a, compute_dtype), as_operand(b, compute_dtype))
    if a2 is not None:
        y2 = torch.matmul(as_operand(a2, compute_dtype), as_operand(b2, compute_dtype))
        y = torch.cat([y[..., :row_offset, :], y[..., row_offset:, :] + y2], dim=-2)
    y = _epilogue(y, epilogue, bias, mask, scale, residual)
    if epilogue == "relu_grad":
        colsum.copy_(tile_colsums(y))
    if out is not None:
        return out.copy_(y)
    return y.to(out_dtype or accum_dtype(compute_dtype))


def _nn_pair(x, w, compute_dtype):
    """The C arguments of one operand pair (and the tensors they point
    into, kept alive until the launch is queued): A float32 or in the
    compute dtype (bfloat16 A widened, exactly, under float32 compute), B
    rounded to the compute dtype as the kernel would round it."""
    if x.dtype is not compute_dtype:
        if x.dtype is torch.bfloat16:
            x = x.float()
        elif x.dtype is not torch.float32:
            raise TypeError(f"A operands are float32 or {compute_dtype}, not {x.dtype}")
    if w.dtype is not compute_dtype:
        w = w.to(compute_dtype)
    if x.stride(-1) != 1:
        x = x.contiguous()
    if w.stride(-1) != 1:
        w = w.contiguous()
    xs, ws = x.stride(), w.stride()
    return (x, w), (x.data_ptr(), xs[0] if len(xs) == 3 else 0, xs[-2],
                    int(x.dtype is torch.float32), w.data_ptr(), ws[0] if len(ws) == 3 else 0,
                    ws[-2], x.shape[-1])


# What csrc/gemm_nn.cu takes, by the negative code (wf::Refusal) with which
# it refuses a launch that breaks it.
_NN_REFUSALS = {
    -1: "sizes, leading dimensions and row offsets within int32",
    -2: "positive M, N and batch",
    -3: f"N that are multiples of {NN_MULTIPLE}",
    -4: f"out row and batch strides that are multiples of {NN_MULTIPLE} elements and "
        "16-byte aligned data",
    -5: "float32 or bfloat16 compute",
    -6: f"K that are positive multiples of {NN_MULTIPLE}",
    -7: f"A and B row and batch strides that are multiples of {NN_MULTIPLE} elements and "
        "16-byte aligned data",
    -8: "row offsets that are not negative",
    -9: "float32 A under float32 compute",
    -10: "a bias with that epilogue",
    -11: "a mask with the mask epilogue",
    -12: "the epilogues " + ", ".join(EPILOGUES),
    -13: "at most 65535 row tiles, splits and batch entries",
    -14: "a residual and column-sum partials with the relu_grad epilogue",
    -15: f"M that are multiples of {NN_MULTIPLE}",
    -16: "split rows that are positive multiples of 32",
}


def gemm_nn(
    a: torch.Tensor, b: torch.Tensor, *, compute_dtype: torch.dtype,
    a2: torch.Tensor | None = None, b2: torch.Tensor | None = None, row_offset: int = 0,
    epilogue: str = "none", bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, scale: float = 1.0,
    residual: torch.Tensor | None = None, colsum: torch.Tensor | None = None,
    out: torch.Tensor | None = None, out_dtype: torch.dtype | None = None,
    what: str = "GEMM",
) -> torch.Tensor:
    """out = epilogue(round(a) @ round(b) [+ round(a2) @ round(b2) on output
    rows >= row_offset]) on csrc/gemm_nn.cu, one launch.

    a [M, K] or [batch, M, K] (float32, or in the compute dtype); b [K, N]
    or [batch, K, N] (rounded to the compute dtype here when it is not in
    it, as the kernel would round it); a2 [M - row_offset, K2] (output row
    m takes a2 row m - row_offset), b2 [K2, N]. epilogue: "none", "bias_relu"
    (+ bias [N] float32, relu), "gates" (+ bias, sigmoid on the i, f, o
    quarters of N and tanh on g), "mask" (x int8 mask in out's layout x
    scale), "bias_relu_mask" (relu(. + bias) x mask x scale) or "relu_grad"
    (x [residual > 0], residual float32 or bfloat16 in out's layout, x mask x
    scale where a mask is given; the float32 column sums of each NN_ROW_TILE
    rows of each batch entry go to colsum [batch * row_tiles(M), N], unit
    column stride). `out` (float32 or the compute dtype, row stride of its own, e.g.
    a row block of a larger buffer) is written in place; without it one of
    `out_dtype` (default float32) is made. K, N and the row and batch strides
    are multiples of 8 elements, the data 16-byte aligned. On CUDA tensors
    only: what the kernel does not take raises.

    The checks here are few and cheap (the kernel checks the rest and
    returns a refusal code, `_NN_REFUSALS`): on the card's host one call
    costs tens of microseconds, as much as a product at the reference
    width."""
    code = cuda_build.DTYPE_CODES.get(compute_dtype)
    if a.device.type != "cuda" or code is None:
        raise TypeError(f"gemm_nn computes in float32 or bfloat16 on a CUDA tensor, got "
                        f"{compute_dtype} on {a.device}")
    epi = EPILOGUES[epilogue]
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"{what}: a {list(a.shape)} and b {list(b.shape)} disagree on K")
    batch = a.shape[0] if a.dim() == 3 else b.shape[0] if b.dim() == 3 else 1
    if out is None:
        shape = (batch, m, n) if a.dim() == 3 or b.dim() == 3 else (m, n)
        out = torch.empty(shape, dtype=out_dtype or torch.float32, device=a.device)
    elif out.dtype is not torch.float32 and out.dtype is not compute_dtype:
        raise TypeError(f"{what}: out must be float32 or {compute_dtype}, not {out.dtype}")
    oshape, ostride = out.shape, out.stride()
    if (oshape[-2:] != (m, n) or ostride[-1] != 1 or (b.dim() == 3 and b.shape[0] != batch)
            or (oshape[0] if len(oshape) == 3 else 1) != batch):
        raise ValueError(f"{what}: out {list(oshape)} (strides {ostride}) is not the product "
                         f"[{batch}, {m}, {n}] with unit column stride")
    keep, args = _nn_pair(a, b, compute_dtype)
    pairs = [keep]  # the operands the launch reads, alive until it is queued
    if a2 is None:
        args2 = (0, 0, 0, 0, 0, 0, 0, 0)
    else:
        if a2.shape[-2] != m - row_offset or b2.shape[-2] != a2.shape[-1] or b2.shape[-1] != n:
            raise ValueError(f"{what}: a2 {list(a2.shape)} / b2 {list(b2.shape)} do not fit "
                             f"[{m}, {n}] at row offset {row_offset}")
        keep2, args2 = _nn_pair(a2, b2, compute_dtype)
        pairs.append(keep2)
    if epi in (1, 2, 4):
        if bias is None or bias.dtype is not torch.float32 or bias.shape[0] != n:
            raise ValueError(f"{what}: the {epilogue} epilogue takes a float32 bias [{n}]")
        if bias.stride(0) != 1:
            bias = bias.contiguous()
    if (epi in (3, 4) or (epi == 5 and mask is not None)) and (
            mask is None or mask.dtype is not torch.int8 or mask.shape != oshape
            or mask.stride() != ostride):
        raise ValueError(f"{what}: the {epilogue} epilogue takes an int8 mask in out's layout")
    if epi == 5 and (
            residual is None or residual.dtype not in (torch.float32, torch.bfloat16)
            or residual.shape != oshape or residual.stride() != ostride or colsum is None
            or colsum.dtype is not torch.float32 or colsum.stride(-1) != 1
            or tuple(colsum.shape) != (batch * row_tiles(m), n)):
        raise ValueError(f"{what}: the relu_grad epilogue takes a float32 or bfloat16 residual "
                         f"in out's layout and float32 colsum [{batch * row_tiles(m)}, {n}]")
    err = cuda_build.load().wf_gemm_nn(_NN_LAUNCH.pack(
        code, epi, *args, *args2, row_offset, out.data_ptr(),
        ostride[0] if len(ostride) == 3 else 0, ostride[-2], int(out.dtype is torch.bfloat16),
        0 if bias is None else bias.data_ptr(), 0 if mask is None else mask.data_ptr(), scale,
        m, n, batch, cuda_build.stream_ptr(a.device),
        0 if residual is None else residual.data_ptr(), int(residual is not None and
                                                            residual.dtype is torch.bfloat16),
        0 if colsum is None else colsum.data_ptr(), 0 if colsum is None else colsum.stride(0)))
    if err < 0:
        raise ValueError(f"{what}: gemm_nn takes {_NN_REFUSALS[err]}")
    cuda_build.check(err, what)
    gemm_nn.launches += 1
    return out


gemm_nn.launches = 0  # NN launches of csrc/gemm_nn.cu


def tn_splits(k: int, split_rows: int = SPLIT_ROWS) -> int:
    """The splits of a K-long TN reduction: `split_rows` rows each."""
    return -(-k // split_rows)


TN_BLOCKS_PER_SM = 3  # the TN kernels' blocks an SM (__launch_bounds__)


def wave_split_rows(k: int, m: int, n: int, tasks: int, sms: int) -> int:
    """The split rows (a multiple of 32) that make `tasks` x output tiles x
    splits of a K-long [M, N] TN product about one wave of the core on `sms`
    SMs: at K = 12,288, M <= 128 and N = 512 (8 tiles) on 132 SMs, 256 rows
    for one task (48 splits, 384 blocks) and 512 for two (24 splits)."""
    tiles = -(-m // NN_ROW_TILE) * -(-n // 64)
    splits = max(1, sms * TN_BLOCKS_PER_SM // (tasks * tiles))
    rows = -(-k // splits)
    return max(32, -(-rows // 32) * 32)


def gemm_tn_plain(
    a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *, compute_dtype: torch.dtype,
    split_rows: int = SPLIT_ROWS, a_row_offset: int = 0, what: str = "",
) -> torch.Tensor:
    """Plain version of `gemm_tn`: out[s] = round(a'[ks])^T @ round(b[ks])
    in the accumulation dtype for each split s (ks = rows s * split_rows ..),
    a' = `a_row_offset` zero rows over a; with a task axis (a [V, K -
    a_row_offset, M], b [V, K, N], out [V, S, M, N]), task by task."""
    if b.dim() == 3:
        for v in range(b.shape[0]):
            gemm_tn_plain(a[v], b[v], out[v], compute_dtype=compute_dtype,
                          split_rows=split_rows, a_row_offset=a_row_offset)
        return out
    for s in range(out.shape[0]):
        k0, k1 = s * split_rows, (s + 1) * split_rows
        ka = slice(max(k0 - a_row_offset, 0), max(k1 - a_row_offset, 0))
        kb = slice(max(k0, a_row_offset), k1)
        out[s] = as_operand(a[ka], compute_dtype).T @ as_operand(b[kb], compute_dtype)
    return out


def gemm_tn(
    a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *, compute_dtype: torch.dtype,
    split_rows: int = SPLIT_ROWS, a_row_offset: int = 0, what: str = "TN GEMM",
) -> torch.Tensor:
    """out [S, M, N] float32 = the K-split partials of round(a')^T @
    round(b) on csrc/gemm_nn.cu's TN core, one launch: out[s] = a'[ks]^T @
    b[ks] over rows ks = [s * split_rows, (s + 1) * split_rows) of a' [K, M]
    and b [K, N] (both in the compute dtype, row strides of their own, unit
    column stride), where a' is `a_row_offset` zero rows over a [K -
    a_row_offset, M]; S = tn_splits(K, split_rows). With a task axis (a [V,
    K - a_row_offset, M], b [V, K, N], out [V, S, M, N], task strides of
    their own) one launch makes every task's partials. out's split and row
    strides are its own (a block of a larger buffer). `sum_splits` adds the
    partials in split order: no atomics, so two runs give the same bits. M,
    N and the strides are multiples of 8 elements, split_rows of 32, the data
    16-byte aligned. On CUDA tensors only: what the kernel does not take
    raises."""
    code = cuda_build.DTYPE_CODES.get(compute_dtype)
    if a.device.type != "cuda" or code is None:
        raise TypeError(f"gemm_tn computes in float32 or bfloat16 on a CUDA tensor, got "
                        f"{compute_dtype} on {a.device}")
    batch = b.shape[0] if b.dim() == 3 else 1
    k, n = b.shape[-2:]
    m = a.shape[-1]
    if (a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2] or a.shape[-2] != k - a_row_offset
            or a.dtype is not compute_dtype or b.dtype is not compute_dtype
            or a.stride(-1) != 1 or b.stride(-1) != 1):
        raise ValueError(f"{what}: gemm_tn takes a [K - {a_row_offset}, M] and b [K, N] in "
                         f"{compute_dtype} with unit column stride, and a task axis on both or "
                         f"neither, got {a.dtype} {list(a.shape)} and {b.dtype} {list(b.shape)}")
    shape = (tn_splits(k, split_rows), m, n)
    if (out.dtype is not torch.float32 or tuple(out.shape) != (*b.shape[:-2], *shape)
            or out.stride(-1) != 1):
        raise ValueError(f"{what}: out must be float32 {list(b.shape[:-2]) + list(shape)} with "
                         f"unit column stride, got {out.dtype} {list(out.shape)}")

    def task_stride(t):
        return t.stride(0) if batch > 1 else 0

    err = cuda_build.load().wf_gemm_tn(_TN_LAUNCH.pack(
        code, a.data_ptr(), a.stride(-2), b.data_ptr(), b.stride(-2), out.data_ptr(),
        out.stride(-3), out.stride(-2), m, n, k, split_rows, cuda_build.stream_ptr(a.device),
        batch, task_stride(a), task_stride(b), task_stride(out), a_row_offset))
    if err < 0:
        raise ValueError(f"{what}: gemm_tn takes {_NN_REFUSALS[err]}")
    cuda_build.check(err, what)
    gemm_tn.launches += 1
    return out


gemm_tn.launches = 0  # TN launches of csrc/gemm_nn.cu


def workspace(device: torch.device, *specs) -> list[torch.Tensor]:
    """One allocation cut into a tensor for each (shape, dtype) spec, each
    starting 256-byte aligned."""
    sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in specs]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf[o:o + size].view(dtype).view(shape)
            for o, size, (shape, dtype) in zip(offsets, sizes, specs)]
