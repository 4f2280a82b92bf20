"""Operations and bytes of the work a model needs, from its shapes.

The counts are of the work, whatever runs it: each input read once and
each output written once, and of a sparse product only the entries these
inputs hold.  A later change that replaces a kernel does not change them.
"""

from __future__ import annotations

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def itemsize(dtype: str) -> int:
    return _ITEMSIZE[dtype]


def spmm(name: str, rows: int, nnz: int, width: int, size: int) -> dict:
    """``out[r] = Σ w·x[s]`` over ``nnz`` entries of a CSR matrix of
    ``rows`` rows on ``width`` features of ``size`` bytes: the rows read
    and written once, each entry's column index and weight (4 bytes each)
    and the row offsets."""
    return dict(name=name, flops=2 * nnz * width,
                bytes=2 * rows * width * size + 8 * nnz + 4 * (rows + 1),
                peak="fp32_flops")


def bmm(name: str, batch: int, n: int, k: int, f: int, a_size: int,
        b_size: int, out_size: int) -> dict:
    """``batch`` products ``[n, k] @ [k, f]`` on the tensor cores."""
    return dict(name=name, flops=2 * batch * n * k * f,
                bytes=batch * (n * k * a_size + k * f * b_size
                               + n * f * out_size),
                peak="bf16_tensor_flops")


def matmul_flops(m: int, k: int, n: int, train: bool,
                 input_grad: bool) -> int:
    """A ``[m, k] @ [k, n]`` layer; in training also its weight's gradient
    and, where its input needs one, the input's."""
    passes = 1 + (1 + int(input_grad) if train else 0)
    return 2 * m * k * n * passes


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peaks: dict) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the memory's rate."""
    return max(flops / peak_flops, nbytes / peaks["hbm_bytes_per_s"])


def op_seconds(op: dict, peaks: dict) -> float:
    return least_seconds(op["flops"], op["bytes"], peaks[op["peak"]], peaks)
