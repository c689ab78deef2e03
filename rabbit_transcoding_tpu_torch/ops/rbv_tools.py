"""RBV coding tools beyond the plain I/P chain: deblocking, coefficient
threshold, mosaic intra prediction, block motion search and compensation,
and DCT-domain requantisation.

Port of the device functions of ``rabbit_transcoding_tpu/video/rbv.py``
(``_deblock``, ``_threshold_coeffs``, ``_block_means``, ``_mosaic_*``,
``_rate_proxy``, ``_intra_code_frame``, ``_intra_rebuild``, ``_mc_search``,
``_mc_predict``, ``_requant_impl``, ``_requant_compensated_impl``).  Every
function takes tensors with any leading dimensions (the reference ``vmap``s
them over GOPs) and runs as plain torch ops on the tensors' device.

Numerics.  The reference runs as XLA programs, and on the CPU the output
bytes of the port equal the reference's.  Where XLA's CPU code fixes an
order or a rounding that torch would do otherwise, the port spells it out
with explicit fp32 ops, so that the same order runs on any device:

* XLA contracts an elementwise ``a * b + c`` into one fused multiply-add
  where both ops run per element in one loop.  ``fma`` computes it with one
  rounding (``_deblock``'s delta, the compensated requantisation).  The MC
  search's rate bias is a loop-invariant product, computed once and added
  after rounding.
* The block mean of the intra prediction sums in an order fixed per
  program (``block_means``), and the planar mosaic's two resize products
  have two taps each, summed as an FMA chain or as two rounded products
  (``mosaic_planar``).
* XLA's ``floor(log2(a))`` is 12 at a = 8192 (``rate_proxy``).

These orders were read from XLA's compiled CPU code for 16 x 16 blocks, the
only block size the repo's encoders write.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import to_device
from .dct import blockify, dct2d, deblockify, idct2d

# deadzone quantisation offsets: round-half for intra, a wider deadzone for
# inter residuals (rbv._DZ_INTRA / _DZ_INTER)
DZ_INTRA = 0.5
DZ_INTER = 1.0 / 3.0

# block motion search: +/-6 px in steps of 2 (49 candidates, the zero MV
# among them), rate bias lam = 16 * qstep per unit of 4 + |dy| + |dx|
MC_RANGE = 6
MC_STEP = 2
MC_LAMBDA_SCALE = 16.0
MC_OFFSETS = tuple(
    (dy, dx)
    for dy in range(-MC_RANGE, MC_RANGE + 1, MC_STEP)
    for dx in range(-MC_RANGE, MC_RANGE + 1, MC_STEP)
)


def scalar(x: float, device) -> torch.Tensor:
    """A 0-d float32 tensor ON the device: a CPU scalar divisor would let
    CUDA's true-divide multiply by its reciprocal instead."""
    return to_device(torch.tensor(x, dtype=torch.float32), device)


def qstep_for(qstep, x: torch.Tensor) -> torch.Tensor:
    """A quantiser step as a float32 tensor on ``x``'s device that
    broadcasts against ``x``.  ``qstep`` is a float (one step for all of
    ``x``), a 0-d tensor, or a 1-D tensor with one step per item of ``x``'s
    leading axis (the batched multi-stream path stacks streams of different
    QPs on that axis)."""
    if not isinstance(qstep, torch.Tensor):
        return scalar(qstep, x.device)
    if qstep.dim() == 0:
        return qstep
    return qstep.reshape(-1, *([1] * (x.dim() - 1)))


def quantize(c: torch.Tensor, qstep: torch.Tensor, dz: torch.Tensor):
    """sign(c) * floor(|c| / qstep + dz), clipped to +/-32767 (float)."""
    return torch.clamp(
        torch.sign(c) * torch.floor(torch.abs(c) / qstep + dz), -32767, 32767
    )


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding (what XLA's CPU code
    computes for a contracted multiply-add), for float32 tensors or Python
    floats holding float32 values.

    The product of two float32 values is exact in float64.  The float64 sum
    is made round-to-odd (TwoSum gives its error; an inexact even result
    moves one ulp towards the exact value), and round-to-odd at 53 bits
    followed by round-to-nearest at 24 bits is the correctly rounded sum."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (t.double() if isinstance(t, torch.Tensor)
               else to_device(torch.tensor(float(t), dtype=torch.float64),
                              ref.device) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def reconstruct(pix: torch.Tensor, maxval: float) -> torch.Tensor:
    """clip(round(pix), 0, maxval): round half to even."""
    return torch.clamp(torch.round(pix), 0.0, maxval)


# --- deblocking and coefficient threshold ------------------------------------
def deblock(rec: torch.Tensor, qstep, maxval: float,
            block: int) -> torch.Tensor:
    """In-loop deblocking (``rbv._deblock``): the weak filter on 1 px each
    side of every block boundary, vertical boundaries first, then
    horizontal; rec (..., H, W) float32 -> float32, rounded and clipped.
    The thresholds are float32 products of the step (``qstep_for``).
    XLA contracts the delta's first product: delta =
    fma(9, q0 - p0, -(3 * (q1 - p1))) / 16."""
    qs = qstep_for(qstep, rec)
    tc = qs * 0.25
    beta = qs * 1.5
    gate = tc * 10.0

    def filt_v(x: torch.Tensor) -> torch.Tensor:
        *lead, hh, ww = x.shape
        v = x.reshape(*lead, hh, ww // block, block).clone()
        p1 = v[..., :-1, block - 2]
        p0 = v[..., :-1, block - 1]
        q0 = v[..., 1:, 0]
        q1 = v[..., 1:, 1]
        step = q0 - p0
        delta = fma(9.0, step, -(3.0 * (q1 - p1))) * 0.0625
        apply = (torch.abs(delta) < gate) & (torch.abs(step) < beta)
        d = torch.clamp(delta, -tc, tc) * apply
        v[..., :-1, block - 1] += d
        v[..., 1:, 0] -= d
        return v.reshape(*lead, hh, ww)

    rec = filt_v(rec)
    rec = filt_v(rec.transpose(-1, -2)).transpose(-1, -2)
    return reconstruct(rec, maxval)


@functools.lru_cache(maxsize=None)
def zigzag(n: int) -> np.ndarray:
    """Zigzag scan order of an n x n block (flat indices); shared, do not
    write to it."""
    idx = sorted(
        ((i, j) for i in range(n) for j in range(n)),
        key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else -p[0]),
    )
    return np.array([i * n + j for i, j in idx], np.int64)


@functools.lru_cache(maxsize=None)
def hf_rank(block: int) -> np.ndarray:
    """(B, B) zigzag rank of each coefficient position; shared, do not
    write to it."""
    rank = np.empty(block * block, np.int32)
    rank[zigzag(block)] = np.arange(block * block, dtype=np.int32)
    return rank.reshape(block, block)


def threshold_coeffs(q: torch.Tensor, block: int, thr_k: int) -> torch.Tensor:
    """Zero the quantised +/-1 values at zigzag rank >= thr_k (float q)."""
    far = to_device(hf_rank(block) >= thr_k, q.device)
    return torch.where((torch.abs(q) == 1.0) & far, 0.0, q)


# --- mosaic intra prediction -------------------------------------------------
def block_means(x: torch.Tensor, block: int, lanes: bool = True
                ) -> torch.Tensor:
    """(..., H, W) -> (..., nby, nbx) per-block means, summed in the order of
    XLA's CPU code for the reference's intra programs (a block of integers
    sums exactly in any order; the planar prediction's block mean feeds a
    rounding, so there the order matters).

    lanes=True: 8 vector lanes, lane l adds row l of the block and then row
    l + 8, one column after the other; the lanes then reduce as (l, l+4),
    then (l, l+2), then (0, 1).  lanes=False: one sequential sum in
    row-major order."""
    b = blockify(x, block)
    if not lanes:
        acc = b[..., 0, 0]
        for r in range(block):
            for c in range(block):
                if r or c:
                    acc = acc + b[..., r, c]
        return acc / float(block * block)
    half = block // 2
    acc = b[..., :half, 0]
    for c in range(1, block):
        acc = acc + b[..., :half, c]
    for c in range(block):
        acc = acc + b[..., half:, c]
    while acc.shape[-1] > 1:
        n = acc.shape[-1] // 2
        acc = acc[..., :n] + acc[..., n:]
    return acc[..., 0] / float(block * block)


def _prediction_means(mu_hat: torch.Tensor, pred_pl: torch.Tensor,
                      use_pl: torch.Tensor, block: int,
                      vmapped: bool) -> torch.Tensor:
    """Block means of the intra prediction, as XLA's CPU code sums them: a
    DC block (the constant mu_hat) in 8 lanes of block * block / 8
    sequential adds each, reduced by the lane tree (exact doublings); a
    planar block by ``block_means``, in lanes where the resize output lies
    column-major (a program without the per-GOP ``vmap`` that resizes over
    W first), else sequentially in row-major order."""
    lanes = not vmapped and not planar_h_first(*mu_hat.shape[-2:])
    acc = mu_hat
    for _ in range(block * block // 8 - 1):
        acc = acc + mu_hat
    dc = acc * 8.0 / float(block * block)
    return torch.where(use_pl, block_means(pred_pl, block, lanes), dc)


def mosaic_dc(mu: torch.Tensor, block: int) -> torch.Tensor:
    """(..., nby, nbx) -> (..., H, W) per-block constant prediction."""
    return mu.repeat_interleave(block, -2).repeat_interleave(block, -1)


@functools.lru_cache(maxsize=None)
def _linear_taps(n_in: int, n_out: int) -> tuple:
    """The two non-zero taps of ``jax.image.resize(method="linear")``'s
    weight matrix per output sample: (index 0, index 1, weight 0, weight 1),
    float32 weights computed as ``jax/_src/image/scale.py``'s
    ``compute_weight_mat`` does (triangle kernel, normalised columns)."""
    f = np.float32
    inv_scale = f(1.0) / (f(n_out) / f(n_in))
    sample = ((np.arange(n_out, dtype=f) + f(0.5)) * inv_scale
              - f(0.0) * inv_scale - f(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None])
    w = np.maximum(f(0.0), f(1.0) - x).astype(f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0) * np.finfo(f).eps,
                 w / np.where(total != 0, total, f(1.0)), f(0.0)).astype(f)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 f(0.0)).astype(f)
    nz = w != 0
    if (nz.sum(axis=0) > 2).any():
        raise ValueError(f"resize {n_in} -> {n_out} has more than two taps")
    i0 = np.clip(np.argmax(nz, axis=0), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    cols = np.arange(n_out)
    w0 = w[i0, cols]
    w1 = np.where(i1 > i0, w[i1, cols], f(0.0)).astype(f)
    return i0, i1, w0, w1


def _two_tap(x: torch.Tensor, dim: int, n_out: int,
             fused: bool) -> torch.Tensor:
    """Linear resize of ``x`` along ``dim`` to ``n_out`` samples: the sum of
    the two taps, a0 * w0 + a1 * w1, rounded after each product or
    (``fused``) as the FMA chain fma(a1, w1, a0 * w0)."""
    taps = _linear_taps(x.shape[dim], n_out)
    i0, i1, w0, w1 = (to_device(np.ascontiguousarray(t), x.device)
                      for t in taps)
    shape = [1] * x.dim()
    shape[dim] = n_out
    lo = x.index_select(dim, i0) * w0.view(shape)
    hi = x.index_select(dim, i1)
    if fused:
        return fma(hi, w1.view(shape), lo)
    return lo + hi * w1.view(shape)


def planar_h_first(nby: int, nbx: int) -> bool:
    """Whether the planar resize contracts over H first: the einsum path of
    ``jax.image.resize`` takes the cheaper order, H first on a tie."""
    return nby >= nbx


def planar_order(nby: int, nbx: int, vmapped: bool) -> tuple[bool, bool]:
    """(h_first, fused) of the planar resize of an (nby, nbx) mosaic: the
    order of its two products (``planar_h_first``) and whether the second
    one is the FMA chain (else the sum of two rounded products).

    Measured on XLA's CPU code over contraction lengths K from 2 to 66,
    with and without the per-GOP ``vmap`` (``vmapped``): the first product
    is always the FMA chain; the second one is the sum of rounded products
    when K >= 5 and K % 4 is 1 or 2, except that a ``vmap``ped second
    product over H is always the FMA chain."""
    h_first = planar_h_first(nby, nbx)
    k = nbx if h_first else nby
    fused = (vmapped and not h_first) or not (k >= 5 and k % 4 in (1, 2))
    return h_first, fused


def mosaic_planar(mu: torch.Tensor, h: int, w: int,
                  vmapped: bool = False) -> torch.Tensor:
    """(..., nby, nbx) mosaic -> (..., H, W), bilinear at block centers
    (``jax.image.resize(method="linear")``).

    XLA runs it as two products (in the order of ``planar_h_first``) whose
    weight matrices have two non-zero taps per output, so each output of a
    product is either the FMA chain fma(a1, w1, a0 * w0) or the sum of two
    rounded products (``planar_order``)."""
    h_first, fused = planar_order(*mu.shape[-2:], vmapped)
    if h_first:
        return _two_tap(_two_tap(mu, -2, h, True), -1, w, fused)
    return _two_tap(_two_tap(mu, -1, w, True), -2, h, fused)


def rate_proxy(q: torch.Tensor) -> torch.Tensor:
    """Per-block exp-Golomb-ish bit estimate of quantised blocks
    (..., nby, nbx, B, B) -> (..., nby, nbx): 2 * floor(log2 |q|) + 3 per
    non-zero.  floor(log2 a) is taken from the float exponent (exact), with
    the reference's value at a = 8192 and 32768: XLA's CPU log2 gives 12
    and 14 there."""
    a = torch.abs(q)
    e = torch.frexp(torch.clamp(a, min=1.0)).exponent.to(torch.float32) - 1.0
    e = torch.where((a == 8192.0) | (a == 32768.0), e - 1.0, e)
    bits = torch.where(a > 0, 2.0 * e + 3.0, 0.0)
    return bits.sum(dim=(-1, -2))


def _code_block_residual(res: torch.Tensor, qstep, block: int,
                         thr_k: int) -> torch.Tensor:
    dz = scalar(DZ_INTRA, res.device)
    c = dct2d(blockify(res, block))
    q = quantize(c, qstep_for(qstep, c), dz)
    if thr_k:
        q = threshold_coeffs(q, block, thr_k)
    # the residual DC is rebuilt from the mosaic, never coded
    q[..., 0, 0] = 0.0
    return q


def _intra_rec(pred_dc, pred_pl, use_pl, mu_hat, q, qstep, maxval, block,
               deblock_on, vmapped):
    qs = qstep_for(qstep, q)
    pred = torch.where(mosaic_dc(use_pl, block), pred_pl, pred_dc)
    # exact residual-DC rebuild: the block mean of rec equals mu_hat
    means = _prediction_means(mu_hat, pred_pl, use_pl, block, vmapped)
    corr = mosaic_dc(mu_hat - means, block)
    rec = reconstruct(pred + corr + deblockify(idct2d(q * qs)), maxval)
    if deblock_on:
        rec = deblock(rec, qstep, maxval, block)
    return rec


def intra_code_frame(frame: torch.Tensor, qstep: float, maxval: float,
                     block: int, deblock_on: bool = False, thr_k: int = 0,
                     vmapped: bool = False):
    """Intra-code frames (..., H, W) float32 -> (q int16 (..., nby, nbx, B,
    B) with the quantised block DC in slot [0, 0], mode uint8 (..., nby,
    nbx): 1 = planar, rec float32 (..., H, W))."""
    h, w = frame.shape[-2:]
    qs = qstep_for(qstep, frame)  # the mosaic (..., nby, nbx) has frame's rank
    dz = scalar(DZ_INTRA, frame.device)
    # the DC slot carries what the plain codec would code there (the 2D DCT
    # DC is B * mean)
    dc_q = quantize(block_means(frame, block) * block, qs, dz)
    mu_hat = dc_q * (qs / block)
    pred_dc = mosaic_dc(mu_hat, block)
    pred_pl = mosaic_planar(mu_hat, h, w, vmapped)
    q_dc = _code_block_residual(frame - pred_dc, qstep, block, thr_k)
    q_pl = _code_block_residual(frame - pred_pl, qstep, block, thr_k)
    use_pl = rate_proxy(q_pl) < rate_proxy(q_dc)
    q = torch.where(use_pl[..., None, None], q_pl, q_dc)
    rec = _intra_rec(pred_dc, pred_pl, use_pl, mu_hat, q, qstep, maxval,
                     block, deblock_on, vmapped)
    q[..., 0, 0] = dc_q
    return q.to(torch.int16), use_pl.to(torch.uint8), rec


def intra_rebuild(q: torch.Tensor, mode: torch.Tensor, qstep: float,
                  maxval: float, block: int, deblock_on: bool = False,
                  vmapped: bool = False) -> torch.Tensor:
    """Decode intra frames: q (..., nby, nbx, B, B) with the block DC in
    slot [0, 0], mode (..., nby, nbx) -> rec float32 (..., H, W)."""
    nby, nbx = q.shape[-4], q.shape[-3]
    qf = q.to(torch.float32)
    mu_hat = qf[..., 0, 0] * (qstep_for(qstep, mode) / block)
    pred_dc = mosaic_dc(mu_hat, block)
    pred_pl = mosaic_planar(mu_hat, nby * block, nbx * block, vmapped)
    deq = qf.clone()
    deq[..., 0, 0] = 0.0
    return _intra_rec(pred_dc, pred_pl, mode.to(torch.bool), mu_hat, deq,
                      qstep, maxval, block, deblock_on, vmapped)


# --- motion search and compensation ------------------------------------------
def _offsets(device) -> torch.Tensor:
    return to_device(torch.tensor(MC_OFFSETS, dtype=torch.int64), device)


def mc_predict(prev: torch.Tensor, mv_idx: torch.Tensor,
               block: int) -> torch.Tensor:
    """Per-block motion compensation: prev (..., H, W), mv_idx (..., nby,
    nbx) indices into ``MC_OFFSETS`` -> the prediction, a clipped-index
    gather (the edge padding of the search)."""
    h, w = prev.shape[-2:]
    offs = _offsets(prev.device)[mv_idx.long()]
    dy = mosaic_dc(offs[..., 0], block)
    dx = mosaic_dc(offs[..., 1], block)
    ys = torch.arange(h, device=prev.device)[:, None] + dy
    xs = torch.arange(w, device=prev.device)[None, :] + dx
    idx = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    lead = torch.broadcast_shapes(prev.shape[:-2], idx.shape[:-2])
    src = prev.expand(*lead, h, w).reshape(*lead, h * w)
    idx = idx.expand(*lead, h, w).reshape(*lead, h * w)
    return src.gather(-1, idx).reshape(*lead, h, w)


def mc_search(frame: torch.Tensor, prev: torch.Tensor, block: int,
              lam: float, weight: torch.Tensor | None = None):
    """-> (mv_idx (..., nby, nbx) int32, pred (..., H, W)): per block the
    candidate of least cost = SAD (optionally weighted per pixel) + lam *
    (4 + |dy| + |dx|) for a non-zero motion, the first one in
    ``MC_OFFSETS`` order on a tie.  The SADs of integer samples with
    integer weights are exact in float32 up to 2^24 per block (16 x 16
    10-bit samples with 0/1 weights stay far below it); the bias is the
    float32 product, rounded before the add (XLA's CPU code hoists it out
    of the per-block loop, so it is not fused with the add)."""
    h, w = frame.shape[-2:]
    r = MC_RANGE
    dev = frame.device
    iy = (torch.arange(h + 2 * r, device=dev) - r).clamp(0, h - 1)
    ix = (torch.arange(w + 2 * r, device=dev) - r).clamp(0, w - 1)
    padded = prev.index_select(-2, iy).index_select(-1, ix)
    nb = frame.shape[:-2] + (h // block, w // block)
    best_cost = torch.full(nb, torch.inf, dtype=torch.float32, device=dev)
    best_idx = torch.zeros(nb, dtype=torch.int32, device=dev)
    for si, (dy, dx) in enumerate(MC_OFFSETS):
        shifted = padded[..., r + dy:r + dy + h, r + dx:r + dx + w]
        diff = torch.abs(frame - shifted)
        if weight is not None:
            diff = diff * weight
        cost = blockify(diff, block).sum(dim=(-1, -2))
        if dy or dx:
            bias = np.float32(lam) * np.float32(4.0 + abs(dy) + abs(dx))
            cost = cost + float(bias)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_idx = torch.where(better, si, best_idx)
    return best_idx, mc_predict(prev, best_idx, block)


# --- DCT-domain requantisation -----------------------------------------------
def requant(q: torch.Tensor, qstep_old, qstep_new) -> torch.Tensor:
    """Open-loop rescale: round(q * qstep_old / qstep_new), int16.  The
    steps are floats or per-frame tensors (``qstep_for``)."""
    c = q.to(torch.float32) * qstep_for(qstep_old, q)
    return torch.clamp(torch.round(c / qstep_for(qstep_new, q)), -32767,
                       32767).to(torch.int16)


def requant_compensated(q: torch.Tensor, qstep_old, qstep_new,
                        gop: int) -> torch.Tensor:
    """Drift-compensated requantisation of zero-MV P chains: each frame's
    requantisation error folds into the next frame's target in the
    coefficient domain (``rbv._requant_compensated_impl``); q (F, ...) int16
    -> int16, GOPs in parallel.  The steps are floats or per-frame (F,)
    tensors.  XLA contracts both multiply-adds."""
    f = q.shape[0]
    pad = (-f) % gop
    if pad:
        q = torch.cat([q, q.new_zeros((pad,) + q.shape[1:])])
    g = q.reshape((-1, gop) + q.shape[1:]).to(torch.float32)

    def per_gop(qstep):
        if not isinstance(qstep, torch.Tensor):
            return [float(np.float32(qstep))] * gop
        if qstep.dim() == 0:
            return [qstep] * gop
        steps = torch.cat([qstep, qstep[-1:].expand(pad)]).reshape(-1, gop)
        return [qstep_for(steps[:, k], g[:, k]) for k in range(gop)]

    qs_old, qs_new = per_gop(qstep_old), per_gop(qstep_new)
    err = torch.zeros_like(g[:, 0])
    out = []
    for k in range(gop):
        target = fma(g[:, k], qs_old[k], err)
        qn = torch.clamp(torch.round(target / qstep_for(qs_new[k], target)),
                         -32767, 32767)
        err = fma(-qn, qs_new[k], target)
        out.append(qn.to(torch.int16))
    return torch.stack(out, 1).reshape((-1,) + q.shape[1:])[:f]
