"""Fused admission (``admit``): B rows screened against n basis rows and
assigned to the nearest of K centroids, each admitted row written back in
int8 with its scale.

Operations: 2 B d (K + n) + 2 K d + 4 B d. Bytes: x, basis and centroids
read, the live mask, r / keep / label / sim out (13 B a row), the int8
row and its scale."""
from bench.cost import bound_ms


def work(B: int, d: int, K: int, n: int):
    flops = 2.0 * B * d * (K + n) + 2.0 * K * d + 4.0 * B * d
    nbytes = 4 * (B * d + n * d + K * d) + B + B * 13 + B * d + 4 * B
    return flops, nbytes


def bound(B: int, d: int, K: int, n: int) -> float:
    return bound_ms(*work(B, d, K, n))
