"""Scalar NumPy oracle for SIFT, transcribed from the semantics of
/root/reference/vl/sift.c (same math as the JAX kernels, but written as the
reference's per-pixel/per-keypoint loops). Used to validate the vectorized
device kernels on small images. Uses exact exp/atan2/sqrt like the JAX build
(the VLFeat fast_* approximations are a documented non-goal, SURVEY.md §7).
"""
import math

import numpy as np

NBO, NBP = 8, 4
EPS_F = 1.19209290e-07
EPS_D = 2.220446049250313e-16


class Cfg:
    def __init__(self, n_octaves=2, n_levels=2, peak=0.0, edge=10.0):
        self.O = n_octaves
        self.S = n_levels
        self.s_min = -1
        self.s_max = n_levels + 1
        self.sigma_n = 0.5
        self.sigma_k = 2.0 ** (1.0 / n_levels)
        self.sigma0 = 1.6 * self.sigma_k
        self.dsigma0 = self.sigma0 * math.sqrt(1 - 1 / self.sigma_k ** 2)
        self.peak = peak
        self.edge = edge
        self.magnif = 3.0
        self.window_size = NBP / 2


def gauss_blur(img, sigma):
    w = max(math.ceil(4.0 * sigma), 1)
    j = np.arange(2 * w + 1)
    taps = np.exp(-0.5 * ((j - w) / sigma) ** 2)
    taps = (taps / taps.sum()).astype(np.float64)
    pad = np.pad(img, ((0, 0), (w, w)), mode="edge")
    out = np.zeros_like(img)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            out[y, x] = (pad[y, x:x + 2 * w + 1] * taps).sum()
    pad = np.pad(out, ((w, w), (0, 0)), mode="edge")
    out2 = np.zeros_like(img)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            out2[y, x] = (pad[y:y + 2 * w + 1, x] * taps).sum()
    return out2


def build_scale_space(gray, cfg):
    """Returns list of octaves, each [S+3, H, W] float64."""
    octaves = []
    base = gray.astype(np.float64)
    for o in range(cfg.O):
        h, w = base.shape
        levels = []
        if o == 0:
            sa = cfg.sigma0 * cfg.sigma_k ** cfg.s_min
            sb = cfg.sigma_n
            lvl = gauss_blur(base, math.sqrt(sa * sa - sb * sb)) if sa > sb else base
        else:
            lvl = base
        levels.append(lvl)
        for s in range(cfg.s_min + 1, cfg.s_max + 1):
            lvl = gauss_blur(lvl, cfg.dsigma0 * cfg.sigma_k ** s)
            levels.append(lvl)
        octaves.append(np.stack(levels))
        # decimate level index S for the next octave
        nxt = octaves[-1][cfg.S]
        base = nxt[::2, : nxt.shape[1] - 1: 2].copy()
    return octaves


def detect_octave(octave, cfg, o):
    """vl_sift_detect transcription. Returns list of dicts."""
    n_lvl, h, w = octave.shape
    dog = octave[1:] - octave[:-1]
    xper = 2.0 ** o
    tp, te = cfg.peak, cfg.edge
    cands = []
    for si in range(1, dog.shape[0] - 1):
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                v = dog[si, y, x]
                nb = dog[si - 1:si + 2, y - 1:y + 2, x - 1:x + 2].flatten()
                nb = np.delete(nb, 13)  # drop the center
                if (v >= 0.8 * tp and (v > nb).all()) or \
                   (v <= -0.8 * tp and (v < nb).all()):
                    cands.append((si, y, x))
    keys = []
    for si, y0, x0 in cands:
        x, y = x0, y0
        b = np.zeros(3)
        last = None
        for _ in range(5):
            n = dog[si - 1:si + 2, y - 1:y + 2, x - 1:x + 2]
            dx = 0.5 * (n[1, 1, 2] - n[1, 1, 0])
            dy = 0.5 * (n[1, 2, 1] - n[1, 0, 1])
            ds = 0.5 * (n[2, 1, 1] - n[0, 1, 1])
            dxx = n[1, 1, 2] + n[1, 1, 0] - 2 * n[1, 1, 1]
            dyy = n[1, 2, 1] + n[1, 0, 1] - 2 * n[1, 1, 1]
            dss = n[2, 1, 1] + n[0, 1, 1] - 2 * n[1, 1, 1]
            dxy = 0.25 * (n[1, 2, 2] + n[1, 0, 0] - n[1, 2, 0] - n[1, 0, 2])
            dxs = 0.25 * (n[2, 1, 2] + n[0, 1, 0] - n[0, 1, 2] - n[2, 1, 0])
            dys = 0.25 * (n[2, 2, 1] + n[0, 0, 1] - n[0, 2, 1] - n[2, 0, 1])
            a = np.array([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]])
            rhs = np.array([-dx, -dy, -ds])
            if abs(np.linalg.det(a)) < 1e-18:
                b = np.zeros(3)
            else:
                b = np.linalg.solve(a, rhs)
            last = (n[1, 1, 1], dx, dy, ds, dxx, dyy, dxy)
            sx = (1 if (b[0] > 0.6 and x < w - 2) else 0) + \
                 (-1 if (b[0] < -0.6 and x > 1) else 0)
            sy = (1 if (b[1] > 0.6 and y < h - 2) else 0) + \
                 (-1 if (b[1] < -0.6 and y > 1) else 0)
            if sx == 0 and sy == 0:
                break
            x += sx
            y += sy
        center, dx, dy, ds, dxx, dyy, dxy = last
        val = center + 0.5 * (dx * b[0] + dy * b[1] + ds * b[2])
        den = dxx * dyy - dxy * dxy
        score = (dxx + dyy) ** 2 / den if den != 0 else np.inf
        xn, yn, sn = x + b[0], y + b[1], (si - 1 + cfg.s_min + 1) + b[2]
        s_lvl = si - 1 + cfg.s_min + 1  # dog index si corresponds to level si + s_min
        if (abs(val) > tp and 0 <= score < (te + 1) ** 2 / te
                and abs(b[0]) < 1.5 and abs(b[1]) < 1.5 and abs(b[2]) < 1.5
                and 0 <= xn <= w - 1 and 0 <= yn <= h - 1
                and cfg.s_min <= sn <= cfg.s_max):
            keys.append(dict(o=o, ix=x, iy=y, is_=s_lvl,
                             x=xn * xper, y=yn * xper, s=sn,
                             sigma=cfg.sigma0 * 2 ** (sn / cfg.S) * xper))
    return keys


def polar_gradient(levels):
    out = np.zeros(levels.shape + (2,))
    for li, src in enumerate(levels):
        gx = np.gradient(src, axis=1)
        gy = np.gradient(src, axis=0)
        out[li, ..., 0] = np.sqrt(gx ** 2 + gy ** 2)
        out[li, ..., 1] = np.mod(np.arctan2(gy, gx) + 2 * np.pi, 2 * np.pi)
    return out


def orientations(grad, key, cfg, o, w, h):
    """vl_sift_calc_keypoint_orientations transcription (bilinear hist)."""
    xper = 2.0 ** o
    x, y, sigma = key["x"] / xper, key["y"] / xper, key["sigma"] / xper
    xi, yi, si = int(x + 0.5), int(y + 0.5), key["is_"]
    if not (0 <= xi <= w - 1 and 0 <= yi <= h - 1
            and cfg.s_min + 1 <= si <= cfg.s_max - 2):
        return []
    sigmaw = 1.5 * sigma
    wr = max(int(math.floor(3.0 * sigmaw)), 1)
    nbins = 36
    hist = np.zeros(nbins)
    g = grad[si - cfg.s_min - 1]
    for ys in range(max(-wr, -yi), min(wr, h - 1 - yi) + 1):
        for xs in range(max(-wr, -xi), min(wr, w - 1 - xi) + 1):
            dx = (xi + xs) - x
            dy = (yi + ys) - y
            r2 = dx * dx + dy * dy
            if r2 >= wr * wr + 0.6:
                continue
            wgt = math.exp(-r2 / (2 * sigmaw * sigmaw))
            mod = g[yi + ys, xi + xs, 0]
            ang = g[yi + ys, xi + xs, 1]
            fbin = nbins * ang / (2 * np.pi)
            bin_ = int(math.floor(fbin - 0.5))
            rbin = fbin - bin_ - 0.5
            hist[(bin_ + nbins) % nbins] += (1 - rbin) * mod * wgt
            hist[(bin_ + 1) % nbins] += rbin * mod * wgt
    for _ in range(6):
        hist = (np.roll(hist, 1) + hist + np.roll(hist, -1)) / 3.0
    maxh = hist.max()
    angles = []
    for i in range(nbins):
        h0, hm, hp = hist[i], hist[(i - 1) % nbins], hist[(i + 1) % nbins]
        if h0 > 0.8 * maxh and h0 > hm and h0 > hp:
            di = -0.5 * (hp - hm) / (hp + hm - 2 * h0)
            angles.append(2 * np.pi * (i + di + 0.5) / nbins)
            if len(angles) == 4:
                break
    return angles


def descriptor(grad, key, angle0, cfg, o, w, h):
    """vl_sift_calc_keypoint_descriptor transcription."""
    xper = 2.0 ** o
    x, y, sigma = key["x"] / xper, key["y"] / xper, key["sigma"] / xper
    xi, yi, si = int(x + 0.5), int(y + 0.5), key["is_"]
    if not (0 <= xi < w and 0 <= yi < h - 1
            and cfg.s_min + 1 <= si <= cfg.s_max - 2):
        return None
    st0, ct0 = math.sin(angle0), math.cos(angle0)
    sbp = cfg.magnif * sigma + EPS_D
    wr = int(math.floor(math.sqrt(2.0) * sbp * (NBP + 1) / 2.0 + 0.5))
    descr = np.zeros(NBO * NBP * NBP)
    g = grad[si - cfg.s_min - 1]

    def atd(bx, by, bt):
        return (by + NBP // 2) * (NBP * NBO) + (bx + NBP // 2) * NBO + bt

    for dyi in range(max(-wr, 1 - yi), min(wr, h - yi - 2) + 1):
        for dxi in range(max(-wr, 1 - xi), min(wr, w - xi - 2) + 1):
            mod = g[yi + dyi, xi + dxi, 0]
            ang = g[yi + dyi, xi + dxi, 1]
            theta = np.mod(ang - angle0, 2 * np.pi)
            dx = xi + dxi - x
            dy = yi + dyi - y
            nx = (ct0 * dx + st0 * dy) / sbp
            ny = (-st0 * dx + ct0 * dy) / sbp
            nt = NBO * theta / (2 * np.pi)
            win = math.exp(-(nx * nx + ny * ny)
                           / (2.0 * cfg.window_size ** 2))
            binx = int(math.floor(nx - 0.5))
            biny = int(math.floor(ny - 0.5))
            bint = int(math.floor(nt))
            rbinx = nx - (binx + 0.5)
            rbiny = ny - (biny + 0.5)
            rbint = nt - bint
            for dbinx in (0, 1):
                for dbiny in (0, 1):
                    for dbint in (0, 1):
                        if (-(NBP // 2) <= binx + dbinx < NBP // 2
                                and -(NBP // 2) <= biny + dbiny < NBP // 2):
                            weight = win * mod \
                                * abs(1 - dbinx - rbinx) \
                                * abs(1 - dbiny - rbiny) \
                                * abs(1 - dbint - rbint)
                            descr[atd(binx + dbinx, biny + dbiny,
                                      (bint + dbint) % NBO)] += weight
    norm = np.sqrt((descr ** 2).sum()) + EPS_F
    descr /= norm
    descr = np.minimum(descr, 0.2)
    norm = np.sqrt((descr ** 2).sum()) + EPS_F
    descr /= norm
    return descr


def extract(gray, cfg=None):
    """Full oracle pipeline: returns list of (x, y, sigma, angle, desc)."""
    cfg = cfg or Cfg()
    octs = build_scale_space(gray, cfg)
    out = []
    for o, octave in enumerate(octs):
        h, w = octave.shape[1:]
        keys = detect_octave(octave, cfg, o)
        grad = polar_gradient(octave[1:1 + cfg.S])
        for k in keys:
            for ang in orientations(grad, k, cfg, o, w, h):
                d = descriptor(grad, k, ang, cfg, o, w, h)
                if d is not None:
                    out.append((k["x"], k["y"], k["sigma"], ang, d))
    return out
