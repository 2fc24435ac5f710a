"""Python side of csrc/gemm.cu (the tiled GEMM and the fixed-order
reductions) and csrc/gemm_nn.cu (the pipelined NN GEMM core, `gemm_nn`,
with its plain version `gemm_nn_plain`): one launch per call, on CUDA
tensors only and outside autograd.

Matrices are row-major with a row stride (`ld*`) and unit column stride;
the kernels round both operands to the compute dtype as they load them and
accumulate in float32.
"""

from __future__ import annotations

import struct

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build

# K rows per split of a long reduction (a weight gradient over every slice
# and node, or every step and row): 12,288 rows at the reference width make
# 48 partials, enough blocks to fill the card.
SPLIT_ROWS = 256


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def gemm(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
    m: int, n: int, k: int, lda: int, ldb: int, ldc: int,
    compute_dtype: torch.dtype,
    trans_a: bool = False, trans_b: bool = False,
    sa: int = 0, sb: int = 0, sc: int = 0, batch: int = 1,
    splits: int = 1, kc: int | None = None,
    bias: torch.Tensor | None = None, relu: bool = False,
    amask: torch.Tensor | None = None, ascale: float = 1.0,
    cmask: torch.Tensor | None = None, cscale: float = 1.0,
    what: str = "GEMM",
) -> None:
    """c[z] = epilogue(op(a) @ op(b)) for z in [0, batch * splits): see
    `wf::Gemm` in csrc/gemm.cu for the indexing."""
    code = cuda_build.dtype_code
    gemm.launches += 1
    cuda_build.check(
        cuda_build.load().wf_gemm(
            code(a.dtype), code(b.dtype), code(c.dtype), code(compute_dtype),
            a.data_ptr(), sa, lda, int(trans_a), _ptr(amask), ascale,
            b.data_ptr(), sb, ldb, int(trans_b),
            c.data_ptr(), sc, ldc, _ptr(bias), int(relu), _ptr(cmask), cscale,
            m, n, k, batch, splits, kc or k, cuda_build.stream_ptr(c.device),
        ),
        what,
    )


gemm.launches = 0  # launches of csrc/gemm.cu's tiled GEMM


def sum_splits(part: torch.Tensor, out: torch.Tensor, what: str) -> None:
    """out [M, N] (row stride out.stride(0)) = part [S, M, N] summed over S
    in order."""
    splits, m, n = part.shape
    cuda_build.check(
        cuda_build.load().wf_sum_splits(
            part.data_ptr(), splits, m * n, out.data_ptr(), m, n, out.stride(0),
            cuda_build.stream_ptr(out.device),
        ),
        what,
    )


def matmul_tn(
    a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
    compute_dtype: torch.dtype,
    amask: torch.Tensor | None = None, ascale: float = 1.0, what: str,
) -> None:
    """out [M, N] float32 = round(a)^T @ round(b) for a [K, M], b [K, N]
    (row-major, row strides of their own): split over K, the partials added
    in split order. `amask` (a's layout) multiplies a by amask * ascale
    before rounding. `out` may be a row block of a larger matrix."""
    matmul_tn_sum([(a, b, amask, ascale)], out, compute_dtype=compute_dtype, what=what)


def matmul_tn_sum(
    terms, out: torch.Tensor, *, compute_dtype: torch.dtype, what: str
) -> None:
    """out [M, N] float32 = the sum over `terms` (a, b, amask, ascale) of
    matmul_tn's products: each split over its K, every partial added in one
    fixed order (term by term, split by split)."""
    m, n = out.shape
    splits = [-(-a.shape[0] // SPLIT_ROWS) for a, *_ in terms]
    if sum(splits) == 0:
        out.zero_()
        return
    part = torch.empty((sum(splits), m, n), dtype=torch.float32, device=out.device)
    z = 0
    for (a, b, amask, ascale), s in zip(terms, splits):
        if s:
            gemm(
                a, b, part[z:z + s], m=m, n=n, k=a.shape[0], lda=a.stride(0),
                ldb=b.stride(0), ldc=n, sc=m * n, splits=s, kc=SPLIT_ROWS,
                trans_a=True, amask=amask, ascale=ascale,
                compute_dtype=compute_dtype, what=what,
            )
        z += s
    sum_splits(part, out, what)


def colsum(x: torch.Tensor, out: torch.Tensor, what: str) -> None:
    """out [N] float32 = the column sums of x [rows, N] float32, by row
    chunks, the chunk sums added in order."""
    rows, cols = x.shape
    chunks = -(-rows // SPLIT_ROWS)
    part = torch.empty((chunks, 1, cols), dtype=torch.float32, device=x.device)
    cuda_build.check(
        cuda_build.load().wf_colsum(
            x.data_ptr(), rows, cols, x.stride(0), SPLIT_ROWS, part.data_ptr(),
            cuda_build.stream_ptr(x.device),
        ),
        what,
    )
    sum_splits(part, out.view(1, cols), what)


# gemm_nn's launch arguments, packed as csrc/gemm_nn.cu's `NNLaunch`: 25
# 8-byte integers (pointers as integers), the scale as a double, 4 more.
_NN_LAUNCH = struct.Struct("<25qd4q")
# gemm_nn's epilogues (csrc/gemm_nn.cu `wf::Epilogue`).
EPILOGUES = {"none": 0, "bias_relu": 1, "gates": 2, "mask": 3}
NN_MULTIPLE = 8  # K, N, row strides and batch strides: multiples of 8 elements


def _epilogue(y, epilogue, bias, mask, scale):
    if epilogue == "bias_relu":
        return torch.relu(y + bias)
    if epilogue == "gates":  # gate order i, f, g, o
        i, f, g, o = (y + bias).chunk(4, dim=-1)
        return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)],
                         dim=-1)
    if epilogue == "mask":
        return y * (mask.to(y.dtype) * scale)
    if epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y


def gemm_nn_plain(
    a: torch.Tensor, b: torch.Tensor, *, compute_dtype: torch.dtype,
    a2: torch.Tensor | None = None, b2: torch.Tensor | None = None, row_offset: int = 0,
    epilogue: str = "none", bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, scale: float = 1.0,
    out: torch.Tensor | None = None, out_dtype: torch.dtype | None = None, what: str = "",
) -> torch.Tensor:
    """Plain version of `gemm_nn`, the same rounding points: round(a) @
    round(b) in the accumulation dtype, plus round(a2) @ round(b2) on the
    output rows from `row_offset` on, then the epilogue, stored in
    `out_dtype` (default: the accumulation dtype) or into `out`. `what`
    (gemm_nn's label for its errors) keeps the two signatures one."""
    y = torch.matmul(as_operand(a, compute_dtype), as_operand(b, compute_dtype))
    if a2 is not None:
        y2 = torch.matmul(as_operand(a2, compute_dtype), as_operand(b2, compute_dtype))
        y = torch.cat([y[..., :row_offset, :], y[..., row_offset:, :] + y2], dim=-2)
    y = _epilogue(y, epilogue, bias, mask, scale)
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
    -12: "the epilogues none, bias_relu, gates and mask",
    -13: "at most 65535 row tiles and batch entries",
}


def gemm_nn(
    a: torch.Tensor, b: torch.Tensor, *, compute_dtype: torch.dtype,
    a2: torch.Tensor | None = None, b2: torch.Tensor | None = None, row_offset: int = 0,
    epilogue: str = "none", bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, scale: float = 1.0,
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
    quarters of N and tanh on g) or "mask" (x int8 mask in out's layout x
    scale). `out` (float32 or the compute dtype, row stride of its own, e.g.
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
    if epi == 1 or epi == 2:
        if bias is None or bias.dtype is not torch.float32 or bias.shape[0] != n:
            raise ValueError(f"{what}: the {epilogue} epilogue takes a float32 bias [{n}]")
        if bias.stride(0) != 1:
            bias = bias.contiguous()
    elif epi == 3 and (mask is None or mask.dtype is not torch.int8 or mask.shape != oshape
                       or mask.stride() != ostride):
        raise ValueError(f"{what}: the mask epilogue takes an int8 mask in out's layout")
    err = cuda_build.load().wf_gemm_nn(_NN_LAUNCH.pack(
        code, epi, *args, *args2, row_offset, out.data_ptr(),
        ostride[0] if len(ostride) == 3 else 0, ostride[-2], int(out.dtype is torch.bfloat16),
        0 if bias is None else bias.data_ptr(), 0 if mask is None else mask.data_ptr(), scale,
        m, n, batch, cuda_build.stream_ptr(a.device)))
    if err < 0:
        raise ValueError(f"{what}: gemm_nn takes {_NN_REFUSALS[err]}")
    cuda_build.check(err, what)
    gemm_nn.launches += 1
    return out


gemm_nn.launches = 0  # launches of csrc/gemm_nn.cu
