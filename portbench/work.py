"""The yardstick's arithmetic: peaks of the card, least times, and the work
(operations and bytes) of the kernels and of the model's steps, from shapes.

``attention_work``, ``sampler_work``, ``bound_ms`` and the peaks are frozen
copies of ``transformer_gan_torch/kernel_check.py`` (each input read once,
each output written once, masked scores not counted), kept here so that a
change to the program cannot change what its kernels are measured against.
The model's operation counts (``mle_step_flops``, ``gen_token_flops``) count
what the forward and backward passes need: no recompute, no masked score.
"""
from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: bf16 tensor-core
# peak, fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """Least ms of a call: the larger of its bytes over the bandwidth and its
    operations over the peak rate of its type."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]) * 1e3


def open_scores(q: int, M: int, count: int, reset: bool = False) -> int:
    """Scores a query block of ``q`` rows leaves open over ``count`` valid
    memory slots of a ring of ``M`` (the causal band, same_length off); a
    reset row sees no memory."""
    return q * (q + 1) // 2 + (0 if reset else q * min(count, M))


def attention_work(q: int, B: int, M: int, count: int, backward: bool = False,
                   H: int = 10, dh: int = 50, es: int = 2):
    """(bytes, flops) of one K1f call (``backward``: K1b) over B rows and H
    heads, no row reset, same_length off."""
    nv = open_scores(q, M, count) * H * B
    nv_cur = open_scores(q, 0, 0) * H * B
    ins = es * (4 * H * B * q * dh + 2 * H * B * M * dh + H * (M + 2 * q) * dh)
    if not backward:
        return ins + 4 * (H * B * q * dh + 2 * H * B * q), 2 * dh * 3 * nv
    ins += 4 * (2 * H * B * q + 2 * H * B * q * dh)
    outs = es * 4 * H * B * q * dh + 4 * H * (M + 2 * q) * dh
    return ins + outs, 2 * dh * (6 * nv + 2 * nv_cur)


def _weights(L, HD, DI, V, es):
    """Bytes of the stacked decode operands (weights, biases, layer norms in
    fp32, the two embedding copies, r_w_bias / r_r_bias)."""
    return (es * (L * (4 * HD * HD + 2 * HD * DI + DI + HD) + 2 * V * HD + V
                  + 2 * HD) + 4 * 4 * L * HD)


def _decode_keys(M: int, count: int, t: int) -> int:
    """Keys token t of a chunk attends to (big slots and staged rows)."""
    return M - min(M, max(M - count, t)) + t + 1


def sampler_work(n, B, M, count, L=6, HD=500, DI=1000, V=310, es=2, t0=0):
    """(bytes, flops) of n tokens of the decode chain from chunk step ``t0``
    (one K3 call at 0)."""
    big = M - min(M, max(M - count, t0))
    nbytes = (es * (2 * L * B * big * HD + L * (M + 1) * HD)
              + _weights(L, HD, DI, V, es) + 4 * n * B * V + 8 * B
              + 4 * n * B * V + es * 2 * L * B * (t0 + n) * HD)
    flops = B * sum(L * (2 * (4 * HD * HD + 2 * HD * DI)
                         + 6 * HD * _decode_keys(M, count, t)) + 2 * HD * V
                    for t in range(t0, t0 + n))
    return nbytes, flops


def generate_chunks(length: int, M: int, chunk: int = 32):
    """(n, count) of the K3 calls of one wave: ``length`` tokens after the
    first on an empty ring of ``M`` slots, ``chunk`` tokens a call."""
    C = min(chunk, length, M)
    count, out = 0, []
    for s in range(0, length, C):
        n = min(C, length - s)
        out.append((n, count))
        count = min(count + n, M)
    return out


def layer_dense_flops(d: int, hd: int, di: int) -> int:
    """Forward operations of one token's dense products in one layer: the
    q / k / v and output projections and the two feed-forward products."""
    return 2 * (3 * d * hd + hd * d + 2 * d * di)


def mle_step_flops(resets, q, M, count, L=6, d=500, H=10, dh=50, di=1000,
                   V=310) -> int:
    """Operations of one MLE step (forward and backward, backward counted as
    twice the forward) over rows whose memory is reset where ``resets`` is
    true, with ``count`` valid memory slots: the dense products of every
    token, the position projection of the step's keys, the open scores
    (QK, the position term and PV) and the output layer."""
    B = len(resets)
    hd = H * dh
    klen = M + q
    dense = B * q * (L * layer_dense_flops(d, hd, di) + 2 * d * V)
    rproj = L * 2 * klen * d * hd
    nv = sum(open_scores(q, M, count, bool(r)) for r in resets) * H
    attn = L * nv * 3 * 2 * dh
    return 3 * (dense + rproj + attn)


def gen_wave_flops(lanes: int, length: int, M: int, L=6, d=500, H=10, dh=50,
                   di=1000, V=310) -> int:
    """Forward operations of one generation wave: ``lanes`` lanes of
    ``length`` tokens after the first, token t seeing t + 1 keys."""
    hd = H * dh
    per = L * layer_dense_flops(d, hd, di) + 2 * d * V
    keys = sum(min(t + 1, M) for t in range(length))
    return lanes * (length * per + L * 3 * 2 * hd * keys)
