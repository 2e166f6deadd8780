"""Plain float32 Transformer-XL, the benchmark's reference.

The model of the source (amazon-science/transformer-gan, Transformer-XL with
post-LayerNorm decoder layers and relative positions, Dai et al. 2019) with
the memory the configuration states (``TPU.cache_kv: true``): each layer keeps
the keys and values it projected for the last ``M`` tokens and attends to
them beside the current segment. Written from the equations in plain torch:
no kernel, no cache layout, no part of the program under test is imported.

Departures from a textbook forward, each one the configuration's:
- dropout masks are drawn as the configuration's training step draws them
  (``dropout_seeds``, ``attention_keep``), so that the reference follows the
  same random function as the program, not another draw of it;
- ``quant``, when given, rounds every matrix product's operands (the
  control's lower precision); the reference itself passes none.
"""
from __future__ import annotations

import math

import torch

LN_EPS = 1e-5
SEED_STRIDE = 1_000_003
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def leaf_shapes(L: int, d: int, H: int, dh: int, di: int, V: int) -> dict:
    """Name -> shape of every trained leaf (tied embedding and softmax)."""
    shapes = {"word_emb": (V, d), "crit_bias": (V,), "r_w_bias": (H, dh),
              "r_r_bias": (H, dh)}
    for i in range(L):
        p = f"layers.{i}."
        shapes.update({p + "qkv_w": (d, 3 * H * dh), p + "r_w": (d, H * dh),
                       p + "o_w": (H * dh, d), p + "attn_ln_scale": (d,),
                       p + "attn_ln_bias": (d,), p + "ff_w1": (d, di),
                       p + "ff_b1": (di,), p + "ff_w2": (di, d),
                       p + "ff_b2": (d,), p + "ff_ln_scale": (d,),
                       p + "ff_ln_bias": (d,)})
    return shapes


def make_weights(shapes: dict, seed: int, device, std: float = 0.01) -> dict:
    """Seeded fp32 weights made on ``device`` in one draw: normal(0, std) for
    matrices and the attention biases, normal(1, std) for LayerNorm scales,
    zero for the other biases."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device) * std
    out, off = {}, 0
    for name in sorted(shapes):
        n = math.prod(shapes[name])
        w = flat[off:off + n].view(shapes[name])
        off += n
        if name.endswith("_ln_scale"):
            w = w + 1.0
        elif name.endswith(("_b1", "_b2", "_ln_bias")) or name == "crit_bias":
            w = torch.zeros_like(w)
        out[name] = w
    return out


# ---------------------------------------------------------------------------
# Dropout draws of the configuration's training step
# ---------------------------------------------------------------------------

def step_seeds(run_seed: int, step: int, chunks: int) -> list[int]:
    """The seeds of a step's micro-batches: from a CPU generator seeded by
    (run seed, step)."""
    gen = torch.Generator().manual_seed(
        (int(run_seed) * SEED_STRIDE + int(step)) % (2 ** 63))
    return torch.randint(0, 2 ** 62, (chunks,), generator=gen).tolist()


def dropout_seeds(chunk_seed: int, L: int) -> tuple[list[int], int]:
    """(one attention-dropout seed a layer, the seed of the device generator
    of the other dropout masks) of one micro-batch's forward."""
    seeds = torch.randint(0, 2 ** 31 - 1, (L + 1,),
                          generator=torch.Generator().manual_seed(
                              int(chunk_seed))).tolist()
    return seeds[:L], seeds[L]


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x346CA68B) & _M32
    return x ^ (x >> 16)


def attention_keep(seed: int, H: int, B: int, q: int, klen: int,
                   rate: float, rows: slice, device) -> torch.Tensor:
    """Keep mask [b, H, q, klen] of the attention probabilities of batch rows
    ``rows`` (of B): score (i, j) of head h and row b is kept where a 32-bit
    hash of (seed, h * B + b, i, j) is at least rate * 2^32."""
    b = torch.arange(B, device=device, dtype=torch.int64)[rows]
    h = torch.arange(H, device=device, dtype=torch.int64)
    bh = (h[None, :] * B + b[:, None])[:, :, None, None]
    i = torch.arange(q, device=device, dtype=torch.int64)[None, None, :, None]
    j = torch.arange(klen, device=device, dtype=torch.int64)[None, None, None]
    s = _mix(torch.tensor((int(seed) + 0x9E3779B9) & _M32, device=device))
    k = _mix(s ^ ((bh + 0x7F4A7C15) & _M32))
    row = _mix(k ^ ((i + 0x6A09E667) & _M32))
    bits = _mix(row ^ ((j + 0xBB67AE85) & _M32))
    return bits >= min(int(rate * (1 << 32)), (1 << 32) - 1)


class Masks:
    """The dropout keep masks of one micro-batch's forward, drawn in the
    order the forward uses them, over the whole batch: the embedding, the
    position embedding, then per layer the attention output, the FF hidden
    and the FF output, then the last hidden."""

    def __init__(self, gen_seed: int, shapes: list, rate: float, device):
        gen = torch.Generator(device=device).manual_seed(int(gen_seed))
        self.keep = [torch.rand(s, generator=gen, device=device) < 1.0 - rate
                     for s in shapes]
        self.rate = rate

    def apply(self, k: int, x: torch.Tensor, rows=None) -> torch.Tensor:
        keep = self.keep[k]
        if rows is not None:
            keep = keep[:, rows]
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def mask_shapes(q: int, B: int, klen: int, L: int, d: int, di: int) -> list:
    return ([(q, B, d), (klen, d)] + [(q, B, d), (q, B, di), (q, B, d)] * L
            + [(q, B, d)])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def positions(klen: int, d: int, device) -> torch.Tensor:
    """Sinusoids of the distances klen-1 .. 0, [klen, d]."""
    pos = torch.arange(klen - 1, -1, -1.0, device=device)
    inv = 1.0 / (10000.0 ** (torch.arange(0.0, d, 2.0, device=device) / d))
    s = torch.outer(pos, inv)
    return torch.cat([s.sin(), s.cos()], -1)


def _mm(a, b, quant):
    if quant is None:
        return a @ b
    return quant(a) @ quant(b)


def forward(w: dict, inp: torch.Tensor, mem: list | None, count: int,
            reset: torch.Tensor | None, *, H: int, dh: int,
            masks: Masks | None = None, attn_seeds=None, rate_att: float = 0.0,
            rows: slice | None = None, B_full: int | None = None,
            quant=None):
    """Hidden states [q, b, d] of ids ``inp`` [q, b] and the new K/V of the
    segment. ``mem``: per layer (k, v) [b, H, M, dh] with ``count`` valid
    slots at the tail, or None (no memory); ``reset`` [b] bool masks a row's
    whole memory. ``masks`` / ``attn_seeds`` turn dropout on; ``rows`` is the
    slice of the full batch (of ``B_full`` rows) that ``inp`` holds, which
    picks the rows of the masks."""
    q, b = inp.shape
    L = sum(1 for k in w if k.endswith(".qkv_w"))
    d = w["word_emb"].shape[1]
    M = 0 if mem is None else mem[0][0].shape[2]
    klen = M + q
    dev = inp.device
    B_full = B_full or b
    drop = (lambda k, x: x) if masks is None else (
        lambda k, x: masks.apply(k, x, rows))

    h = drop(0, w["word_emb"][inp] * math.sqrt(d))
    pos = positions(klen, d, dev)
    if masks is not None:
        pos = masks.apply(1, pos)
    i = torch.arange(q, device=dev)[:, None]
    j = torch.arange(klen, device=dev)[None, :]
    masked = ((j > M + i) | (j < M - count))[None, None]        # [1,1,q,klen]
    if reset is not None and M:
        masked = masked | (reset[:, None, None, None] & (j < M)[None, None])
    # distance of key j from query i is M + i - j: row klen-1-(M+i-j) of pos
    ridx = (q - 1 - i + j).clamp(max=klen - 1)
    new_kv = []
    for li in range(L):
        p = f"layers.{li}."
        qkv = _mm(h, w[p + "qkv_w"], quant).view(q, b, 3, H, dh)
        qh, kh, vh = (qkv[:, :, n].permute(1, 2, 0, 3) for n in range(3))
        new_kv.append((kh.detach(), vh.detach()))
        if M:
            kh = torch.cat([mem[li][0], kh], 2)
            vh = torch.cat([mem[li][1], vh], 2)
        r = _mm(pos, w[p + "r_w"], quant).view(klen, H, dh)
        ac = _mm(qh + w["r_w_bias"][None, :, None], kh.transpose(-1, -2),
                 quant)
        bd_all = _mm(qh + w["r_r_bias"][None, :, None],
                     r.permute(1, 2, 0)[None], quant)           # [b,H,q,klen]
        bd = torch.gather(bd_all, 3, ridx.expand(b, H, q, klen))
        s = ((ac + bd) / math.sqrt(dh)).masked_fill(masked, float("-inf"))
        prob = torch.softmax(s, -1)
        if attn_seeds is not None and rate_att > 0.0:
            keep = attention_keep(attn_seeds[li], H, B_full, q, klen,
                                  rate_att, rows or slice(None), dev)
            prob = torch.where(keep, prob / (1.0 - rate_att), 0.0)
        ctx = _mm(prob, vh, quant).permute(2, 0, 1, 3).reshape(q, b, H * dh)
        a = drop(2 + 3 * li, _mm(ctx, w[p + "o_w"], quant))
        out = layer_norm(h + a, w[p + "attn_ln_scale"], w[p + "attn_ln_bias"])
        f = drop(3 + 3 * li, torch.relu(_mm(out, w[p + "ff_w1"], quant)
                                         + w[p + "ff_b1"]))
        f = drop(4 + 3 * li, _mm(f, w[p + "ff_w2"], quant) + w[p + "ff_b2"])
        h = layer_norm(out + f, w[p + "ff_ln_scale"], w[p + "ff_ln_bias"])
    return drop(2 + 3 * L, h), new_kv


def logits(w: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    """Tied softmax layer: h @ word_emb^T + crit_bias."""
    return _mm(h, w["word_emb"].t(), quant) + w["crit_bias"]


def empty_memory(L: int, b: int, H: int, M: int, dh: int, device) -> list:
    """A ring of ``M`` slots a layer, none of them valid yet."""
    z = torch.zeros(b, H, M, dh, device=device)
    return [(z, z) for _ in range(L)]


def roll_memory(mem: list, new_kv: list, count: int):
    """The next step's memory: the newest ``M`` slots of [memory; segment],
    and their count of valid slots."""
    M = mem[0][0].shape[2]
    out = [(torch.cat([ok, k], 2)[:, :, k.shape[2]:],
            torch.cat([ov, v], 2)[:, :, v.shape[2]:])
           for (ok, ov), (k, v) in zip(mem, new_kv)]
    return out, min(count + new_kv[0][0].shape[2], M)
