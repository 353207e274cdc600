"""K1, the gyroplane distances: x (B, D) and points (P, D) on the ball,
bias (P,) -> the signed distance of every row to every plane, (B, P) f32.

Each input byte read once and each output byte written once. Operations:
the products <x, p> (2 D a pair) and the norms |x|^2, |p|^2 (2 D each),
then the epilogue of ``EPILOGUE_OPS`` a pair (the denominator, alpha,
beta, <diff, p>, |diff|^2 and its clamp, |p|, the ratio, arsinh counted
as one, the bias).
"""

from portbench.counts import peaks

EPILOGUE_OPS = 40


def n_bytes(b: int, p: int, d: int) -> int:
    return 4 * (b * d + p * d + p + b * p)


def n_ops(b: int, p: int, d: int) -> int:
    return b * p * (2 * d + EPILOGUE_OPS) + 2 * d * (b + p)


def bound_s(b: int, p: int, d: int) -> float:
    return peaks.bound_s(n_bytes(b, p, d), n_ops(b, p, d))
