"""Plain RBV chains in float32: a frozen copy of the codec's arithmetic.

The RBV I/P chains as the codec defines them: a 16 x 16 block DCT-II as two
float32 matrix products per transform (each 16-term contraction summed as
four interleaved partial sums combined (s0 + s1) + (s2 + s3), TF32 off),
deadzone quantisation (1/2 intra, 1/3 inter), round half to even, mosaic
intra prediction (DC or planar per block, chosen by a rate proxy, the block
DC carried in slot [0, 0]) and motion compensation by per-block candidate
indices (+/-6 pixels in steps of 2, edge-clamped).  Only what the
benchmark's configurations code is here: no deblocking, no coefficient
threshold, no motion search.

``tf32_products()`` runs every transform product with its operands rounded
to TF32 (10 mantissa bits, accumulation in float32, as a tensor core does):
the nearest precision below the configuration's, used as the control.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch

DZ_INTRA = 0.5
DZ_INTER = 1.0 / 3.0
MC_OFFSETS = tuple((dy, dx) for dy in range(-6, 7, 2)
                   for dx in range(-6, 7, 2))

_TF32 = contextvars.ContextVar("tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), half to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def qstep_of(qp: int) -> float:
    """The float32 quantiser step of a QP: 2^((qp - 4) / 6)."""
    return float(np.float32(2.0 ** ((qp - 4.0) / 6.0)))


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    d = d.astype(np.float32)
    d.flags.writeable = False
    return d


def blockify(x: torch.Tensor, b: int) -> torch.Tensor:
    *lead, h, w = x.shape
    return x.reshape(*lead, h // b, b, w // b, b).transpose(-3, -2)


def deblockify(x: torch.Tensor) -> torch.Tensor:
    *lead, nby, nbx, b, b2 = x.shape
    return x.transpose(-3, -2).reshape(*lead, nby * b, nbx * b2)


def _matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32.get():
        a, b = _tf32(a), _tf32(b)
    s = [torch.matmul(a[..., t::4], b[..., t::4, :]) for t in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def _d(n: int, device) -> torch.Tensor:
    return torch.from_numpy(dct_matrix(n).copy()).to(device)


def dct2d(x: torch.Tensor) -> torch.Tensor:
    d = _d(x.shape[-1], x.device)
    return _matmul4(_matmul4(d, x), d.T)


def idct2d(c: torch.Tensor) -> torch.Tensor:
    d = _d(c.shape[-1], c.device)
    return _matmul4(_matmul4(d.T, c), d)


def scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def quantize(c: torch.Tensor, qs: torch.Tensor, dz: torch.Tensor):
    return torch.clamp(torch.sign(c) * torch.floor(torch.abs(c) / qs + dz),
                       -32767, 32767)


def reconstruct(pix: torch.Tensor, maxval: float) -> torch.Tensor:
    return torch.clamp(torch.round(pix), 0.0, maxval)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding: the exact float64 product, a
    round-to-odd float64 sum, then one rounding to float32."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (t.double() if isinstance(t, torch.Tensor)
               else torch.tensor(float(t), dtype=torch.float64,
                                 device=ref.device) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# --- mosaic intra prediction -------------------------------------------------
def block_means(x: torch.Tensor, b: int, lanes: bool = True) -> torch.Tensor:
    """Per-block means in the codec's summation order: 8 lanes (rows l and
    l + 8, column by column, then a lane tree), or one row-major chain."""
    blk = blockify(x, b)
    if not lanes:
        acc = blk[..., 0, 0]
        for r in range(b):
            for c in range(b):
                if r or c:
                    acc = acc + blk[..., r, c]
        return acc / float(b * b)
    half = b // 2
    acc = blk[..., :half, 0]
    for c in range(1, b):
        acc = acc + blk[..., :half, c]
    for c in range(b):
        acc = acc + blk[..., half:, c]
    while acc.shape[-1] > 1:
        n = acc.shape[-1] // 2
        acc = acc[..., :n] + acc[..., n:]
    return acc[..., 0] / float(b * b)


def planar_h_first(nby: int, nbx: int) -> bool:
    return nby >= nbx


def _prediction_means(mu_hat, pred_pl, use_pl, b: int, vmapped: bool):
    lanes = not vmapped and not planar_h_first(*mu_hat.shape[-2:])
    acc = mu_hat
    for _ in range(b * b // 8 - 1):
        acc = acc + mu_hat
    dc = acc * 8.0 / float(b * b)
    return torch.where(use_pl, block_means(pred_pl, b, lanes), dc)


def mosaic_dc(mu: torch.Tensor, b: int) -> torch.Tensor:
    return mu.repeat_interleave(b, -2).repeat_interleave(b, -1)


@functools.lru_cache(maxsize=None)
def _linear_taps(n_in: int, n_out: int) -> tuple:
    """Two taps per output of a linear resize at sample centres (triangle
    kernel, columns normalised), float32."""
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
    i0 = np.clip(np.argmax(nz, axis=0), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    cols = np.arange(n_out)
    w0 = w[i0, cols]
    w1 = np.where(i1 > i0, w[i1, cols], f(0.0)).astype(f)
    return i0, i1, w0, w1


def _two_tap(x: torch.Tensor, dim: int, n_out: int, fused: bool):
    i0, i1, w0, w1 = (torch.from_numpy(np.ascontiguousarray(t)).to(x.device)
                      for t in _linear_taps(x.shape[dim], n_out))
    shape = [1] * x.dim()
    shape[dim] = n_out
    lo = x.index_select(dim, i0) * w0.view(shape)
    hi = x.index_select(dim, i1)
    if fused:
        return fma(hi, w1.view(shape), lo)
    return lo + hi * w1.view(shape)


def mosaic_planar(mu: torch.Tensor, h: int, w: int, vmapped: bool):
    nby, nbx = mu.shape[-2:]
    h_first = planar_h_first(nby, nbx)
    k = nbx if h_first else nby
    fused = (vmapped and not h_first) or not (k >= 5 and k % 4 in (1, 2))
    if h_first:
        return _two_tap(_two_tap(mu, -2, h, True), -1, w, fused)
    return _two_tap(_two_tap(mu, -1, w, True), -2, h, fused)


def rate_proxy(q: torch.Tensor) -> torch.Tensor:
    a = torch.abs(q)
    e = torch.frexp(torch.clamp(a, min=1.0)).exponent.to(torch.float32) - 1.0
    e = torch.where((a == 8192.0) | (a == 32768.0), e - 1.0, e)
    return torch.where(a > 0, 2.0 * e + 3.0, 0.0).sum(dim=(-1, -2))


def _qs(qstep, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(qstep, torch.Tensor):
        return scalar(qstep, x.device)
    return qstep


def _residual_q(res, qstep, b: int):
    c = dct2d(blockify(res, b))
    q = quantize(c, _qs(qstep, c), scalar(DZ_INTRA, res.device))
    q[..., 0, 0] = 0.0
    return q


def _intra_rec(pred_dc, pred_pl, use_pl, mu_hat, q, qstep, maxval, b,
               vmapped):
    pred = torch.where(mosaic_dc(use_pl, b), pred_pl, pred_dc)
    means = _prediction_means(mu_hat, pred_pl, use_pl, b, vmapped)
    corr = mosaic_dc(mu_hat - means, b)
    return reconstruct(pred + corr + deblockify(idct2d(q * _qs(qstep, q))),
                       maxval)


def intra_code_frame(frame, qstep, maxval, b, vmapped):
    h, w = frame.shape[-2:]
    qs = _qs(qstep, frame)
    dc_q = quantize(block_means(frame, b) * b, qs,
                    scalar(DZ_INTRA, frame.device))
    mu_hat = dc_q * (qs / b)
    pred_dc = mosaic_dc(mu_hat, b)
    pred_pl = mosaic_planar(mu_hat, h, w, vmapped)
    q_dc = _residual_q(frame - pred_dc, qstep, b)
    q_pl = _residual_q(frame - pred_pl, qstep, b)
    use_pl = rate_proxy(q_pl) < rate_proxy(q_dc)
    q = torch.where(use_pl[..., None, None], q_pl, q_dc)
    rec = _intra_rec(pred_dc, pred_pl, use_pl, mu_hat, q, qstep, maxval, b,
                     vmapped)
    q[..., 0, 0] = dc_q
    return q.to(torch.int16), use_pl.to(torch.uint8), rec


def intra_rebuild(q, mode, qstep, maxval, b, vmapped):
    nby, nbx = q.shape[-4], q.shape[-3]
    qf = q.to(torch.float32)
    mu_hat = qf[..., 0, 0] * (_qs(qstep, mode) / b)
    pred_dc = mosaic_dc(mu_hat, b)
    pred_pl = mosaic_planar(mu_hat, nby * b, nbx * b, vmapped)
    deq = qf.clone()
    deq[..., 0, 0] = 0.0
    return _intra_rec(pred_dc, pred_pl, mode.to(torch.bool), mu_hat, deq,
                      qstep, maxval, b, vmapped)


def mc_predict(prev: torch.Tensor, mv: torch.Tensor, b: int):
    h, w = prev.shape[-2:]
    offs = torch.tensor(MC_OFFSETS, dtype=torch.int64,
                        device=prev.device)[mv.long()]
    dy = mosaic_dc(offs[..., 0], b)
    dx = mosaic_dc(offs[..., 1], b)
    ys = torch.arange(h, device=prev.device)[:, None] + dy
    xs = torch.arange(w, device=prev.device)[None, :] + dx
    idx = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    lead = torch.broadcast_shapes(prev.shape[:-2], idx.shape[:-2])
    src = prev.expand(*lead, h, w).reshape(*lead, h * w)
    idx = idx.expand(*lead, h, w).reshape(*lead, h * w)
    return src.gather(-1, idx).reshape(*lead, h, w)


# --- the chains ----------------------------------------------------------------
def _by_gop(x, gop: int):
    if x is None:
        return None
    pad = (-x.shape[0]) % gop
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x.reshape(-1, gop, *x.shape[1:])


def _predict(prev, mv, b: int):
    if mv is None:
        return prev
    return blockify(mc_predict(deblockify(prev), mv, b), b)


def decode_chain(q: torch.Tensor, qstep: float, maxval: float, gop: int,
                 mode: torch.Tensor | None = None,
                 mv: torch.Tensor | None = None) -> torch.Tensor:
    """int16 coefficients (F, nby, nbx, B, B) -> recon pixel blocks: I
    frames alone (through the mosaic with ``mode``), P frames on the
    previous recon (moved by ``mv``)."""
    f, b = q.shape[0], q.shape[-1]
    vmapped = gop > 1 or mv is not None
    g = _by_gop(q, gop).to(torch.float32)
    gmv = _by_gop(mv, gop)
    recs, prev = [], None
    for k in range(gop):
        if k == 0 and mode is not None:
            prev = blockify(intra_rebuild(g[:, 0], mode, qstep, maxval, b,
                                          vmapped), b)
        else:
            res = idct2d(g[:, k] * scalar(qstep, q.device))
            if k:
                res = _predict(prev, None if gmv is None else gmv[:, k],
                               b) + res
            prev = reconstruct(res, maxval)
        recs.append(prev)
    return torch.stack(recs, 1).reshape(-1, *g.shape[2:])[:f]


def encode_chain(blocks: torch.Tensor, qstep: float, maxval: float,
                 gop: int, intra: bool = False,
                 mv: torch.Tensor | None = None):
    """Pixel blocks -> (int16 coefficients, intra mode maps or None),
    predicting P frames from the closed-loop recon moved by ``mv``."""
    f, b = blocks.shape[0], blocks.shape[-1]
    dev = blocks.device
    vmapped = gop > 1 or mv is not None
    g = _by_gop(blocks.to(torch.float32), gop)
    gmv = _by_gop(mv, gop)
    qs = scalar(qstep, dev)
    q_out, mode, prev = [], None, None
    for k in range(gop):
        frame = g[:, k]
        if k == 0 and intra:
            q, mode, rec = intra_code_frame(deblockify(frame), qstep, maxval,
                                            b, vmapped)
            q_out.append(q)
            prev = blockify(rec, b)
            continue
        pred = None
        if k:
            pred = _predict(prev, None if gmv is None else gmv[:, k], b)
        res = frame if pred is None else frame - pred
        q = quantize(dct2d(res), qs,
                     scalar(DZ_INTER if k else DZ_INTRA, dev))
        q_out.append(q.to(torch.int16))
        if k + 1 < gop:
            r = idct2d(q * qs)
            prev = reconstruct(r if pred is None else pred + r, maxval)
    return (torch.stack(q_out, 1).reshape(-1, *g.shape[2:])[:f], mode)
