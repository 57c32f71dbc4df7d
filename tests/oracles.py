"""NumPy oracles implementing the published equations, independent of JAX.

Parity targets for the JAX implementations (SURVEY.md §4.1): bilinear ROI
sampling, KCF per arXiv:1404.7584 (eqs. 17, 22, 31), constant-velocity
Kalman, SciPy Hungarian.
Everything here is deliberately scalar/loopy NumPy — the point is an
independent derivation from the papers, not speed.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------
# ROI oracle: float64 bilinear crop + resize
# ----------------------------------------------------------------------

def roi_patch(gray, box, padding, size, scale=1.0):
    """Bilinear crop of one (cx, cy, w, h) box's context window, resized
    to [size, size], matching jaxmot.ops.patch.extract_patches: the
    window spans padding * max(w, 1) x padding * max(h, 1) (times
    scale), pixel-center sampling, coordinates clamped to the frame
    (border replication)."""
    gray = np.asarray(gray, np.float64)
    cx, cy, w, h = (float(v) for v in box)
    w = max(w, 1.0) * scale
    h = max(h, 1.0) * scale
    u = (np.arange(size) + 0.5) / size - 0.5
    ys = np.clip(cy + u * h * padding, 0, gray.shape[0] - 1.0)
    xs = np.clip(cx + u * w * padding, 0, gray.shape[1] - 1.0)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, gray.shape[0] - 1)
    x1 = np.minimum(x0 + 1, gray.shape[1] - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    return (gray[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + gray[np.ix_(y0, x1)] * (1 - fy) * fx
            + gray[np.ix_(y1, x0)] * fy * (1 - fx)
            + gray[np.ix_(y1, x1)] * fy * fx)


def roi_patches(gray, boxes, padding, size, scales=None):
    """roi_patch over a [T, 4] box bank (optional [T] scales) →
    [T, size, size] float64."""
    scales = np.ones(len(boxes)) if scales is None else scales
    return np.stack([roi_patch(gray, b, padding, size, sc)
                     for b, sc in zip(boxes, scales)])


# ----------------------------------------------------------------------
# KCF oracle (single track, raw grayscale features)
# ----------------------------------------------------------------------

def hann2d(h, w):
    hy = 0.5 * (1 - np.cos(2 * np.pi * np.arange(h) / (h - 1)))
    hx = 0.5 * (1 - np.cos(2 * np.pi * np.arange(w) / (w - 1)))
    return np.outer(hy, hx)


def gaussian_peak(h, w, sigma):
    cy, cx = h // 2, w // 2
    yy = (np.arange(h) - cy) ** 2
    xx = (np.arange(w) - cx) ** 2
    return np.exp(-0.5 * (yy[:, None] + xx[None, :]) / sigma**2)


def gaussian_correlation(x, z, sigma):
    """arXiv:1404.7584 eq. 31 via full complex FFTs. x, z: [C, S, S]."""
    c = np.zeros(x.shape[1:], np.float64)
    for ch in range(x.shape[0]):
        xf = np.fft.fft2(x[ch])
        zf = np.fft.fft2(z[ch])
        c += np.real(np.fft.ifft2(xf * np.conj(zf)))
    xx = np.sum(x * x)
    zz = np.sum(z * z)
    d = np.clip(xx + zz - 2 * c, 0, None)
    return np.exp(-d / (sigma**2 * x.size))


class KCFOracle:
    """Reference single-object KCF (raw pixels) per the paper's equations."""

    def __init__(self, size=64, padding=2.5, sigma=0.2, lambda_=1e-4,
                 output_sigma_factor=0.125, interp_factor=0.075):
        self.size = size
        self.padding = padding
        self.sigma = sigma
        self.lambda_ = lambda_
        self.interp = interp_factor
        osf = np.sqrt(size * size) / padding * output_sigma_factor
        self.yf = np.fft.fft2(gaussian_peak(size, size, osf))
        self.hann = hann2d(size, size)
        self.tmpl = None
        self.alphaf = None

    def get_patch(self, gray, box, scale=1.0):
        """Bilinear crop matching jaxmot.ops.patch.extract_patches."""
        return roi_patch(gray, box, self.padding, self.size, scale)

    def features(self, patch):
        return ((patch - 0.5) * self.hann)[None]

    def train_once(self, feat):
        k = gaussian_correlation(feat, feat, self.sigma)
        return np.fft.fft2(k) + self.lambda_

    def init(self, gray, box):
        self.box = np.asarray(box, np.float64)
        feat = self.features(self.get_patch(gray, self.box))
        self.tmpl = feat
        self.alphaf = self.yf / self.train_once(feat)

    def response(self, gray, box=None):
        """Response via the standard spectral product (eq. 22)."""
        box = self.box if box is None else box
        feat = self.features(self.get_patch(gray, box))
        k = gaussian_correlation(feat, self.tmpl, self.sigma)
        return np.real(np.fft.ifft2(np.fft.fft2(k) * self.alphaf))

    def update(self, gray):
        """One full detect → move → train step. Returns the new box."""
        resp = self.response(gray)
        s = self.size
        idx = np.argmax(resp)
        py, px = idx // s, idx % s
        peak = resp[py, px]

        def sub(p, lo, hi):
            if 0 < p < s - 1:
                denom = 2 * peak - lo - hi
                if abs(denom) > 1e-8:
                    return np.clip(0.5 * (hi - lo) / denom, -0.5, 0.5)
            return 0.0

        dy = py + sub(py, resp[max(py - 1, 0), px],
                      resp[min(py + 1, s - 1), px]) - s // 2
        dx = px + sub(px, resp[py, max(px - 1, 0)],
                      resp[py, min(px + 1, s - 1)]) - s // 2
        cx, cy, w, h = self.box
        cx += dx * w * self.padding / s
        cy += dy * h * self.padding / s
        self.box = np.array([cx, cy, w, h])
        feat = self.features(self.get_patch(gray, self.box))
        alphaf_new = self.yf / self.train_once(feat)
        self.tmpl = (1 - self.interp) * self.tmpl + self.interp * feat
        self.alphaf = (1 - self.interp) * self.alphaf + self.interp * alphaf_new
        return self.box.copy(), peak


# ----------------------------------------------------------------------
# Kalman oracle (constant velocity on [cx, cy, w, h])
# ----------------------------------------------------------------------

class KalmanOracle:
    def __init__(self, box, pos_std=1 / 20, vel_std=1 / 160,
                 init_vel_cov=1e4, q_pos=1 / 20, q_vel=1 / 160):
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4)
        self.H = np.eye(4, 8)
        self.pos_std = pos_std
        self.vel_std = vel_std
        self.q_pos = q_pos
        self.q_vel = q_vel
        self.x = np.zeros(8)
        self.x[:4] = box
        scale = max(box[2], box[3])
        self.P = np.diag(np.concatenate([
            np.full(4, (2 * pos_std * scale) ** 2),
            np.full(4, init_vel_cov)]))

    def predict(self):
        scale = max(self.x[2], self.x[3], 1.0)
        q = np.diag(np.concatenate([
            np.full(4, (self.q_pos * scale) ** 2),
            np.full(4, (self.q_vel * scale) ** 2)]))
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + q
        return self.x[:4].copy()

    def correct(self, z):
        scale = max(self.x[2], self.x[3], 1.0)
        r = np.diag(np.full(4, (self.pos_std * scale) ** 2))
        s = self.H @ self.P @ self.H.T + r
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ (np.asarray(z) - self.H @ self.x)
        self.P = (np.eye(8) - k @ self.H) @ self.P
        return self.x[:4].copy()


# ----------------------------------------------------------------------
# SORT-style MOT oracle (Kalman + Hungarian, IoU only, no KCF)
# ----------------------------------------------------------------------

class SORTOracle:
    """Mirror of the tracker step with use_kcf=False: per-frame predict →
    IoU-gated Hungarian → correct → lifecycle, in plain NumPy/SciPy."""

    def __init__(self, iou_gate=0.3, n_init=3, max_age=30,
                 max_age_tentative=1):
        self.iou_gate = iou_gate
        self.n_init = n_init
        self.max_age = max_age
        self.max_age_tentative = max_age_tentative
        self.tracks = []          # dicts: kf, id, hits, tsu, state
        self.next_id = 0

    def _assoc(self, pred_boxes, dets):
        from scipy.optimize import linear_sum_assignment
        if not len(pred_boxes) or not len(dets):
            return {}, set(range(len(dets)))
        iou = np.zeros((len(pred_boxes), len(dets)))
        for i, p in enumerate(pred_boxes):
            for j, d in enumerate(dets):
                iou[i, j] = iou_xywh(p, d[:4])
        cost = np.where(iou >= self.iou_gate, 1.0 - iou, 1e4)
        ri, ci = linear_sum_assignment(cost)
        matches = {}
        for r, c in zip(ri, ci):
            if cost[r, c] < 1e3:
                matches[r] = c
        unmatched = set(range(len(dets))) - set(matches.values())
        return matches, unmatched

    def step(self, dets):
        """dets: [D, 5] (cx, cy, w, h, score) → [(id, box)] confirmed."""
        dets = np.asarray(dets, np.float64).reshape(-1, 5)
        pred = [t["kf"].predict() for t in self.tracks]
        matches, unmatched_dets = self._assoc(pred, dets)
        survivors = []
        for i, t in enumerate(self.tracks):
            if i in matches:
                t["kf"].correct(dets[matches[i], :4])
                t["hits"] += 1
                t["tsu"] = 0
                if t["state"] == 1 and t["hits"] >= self.n_init:
                    t["state"] = 2
                survivors.append(t)
            else:
                t["tsu"] += 1
                if t["state"] == 2 and t["tsu"] <= self.max_age:
                    survivors.append(t)
                elif t["state"] == 1 and t["tsu"] <= self.max_age_tentative:
                    survivors.append(t)
        self.tracks = survivors
        for j in sorted(unmatched_dets):
            self.tracks.append({
                "kf": KalmanOracle(dets[j, :4]), "id": self.next_id,
                "hits": 1, "tsu": 0, "state": 1})
            self.next_id += 1
        return [(t["id"], t["kf"].x[:4].copy()) for t in self.tracks
                if t["state"] == 2]


# ----------------------------------------------------------------------
# IoU oracle
# ----------------------------------------------------------------------

def iou_xywh(a, b):
    """IoU of two (cx, cy, w, h) boxes."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0
