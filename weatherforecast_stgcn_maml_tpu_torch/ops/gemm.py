"""Python side of csrc/gemm.cu: the tiled GEMM and the fixed-order
reductions, one launch per call, on CUDA tensors only and outside autograd.

Matrices are row-major with a row stride (`ld*`) and unit column stride;
the kernel rounds both operands to the compute dtype as it loads them and
accumulates in float32.
"""

from __future__ import annotations

import torch

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
