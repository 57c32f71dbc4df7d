"""The fused per-frame MOT step — one jitted device program per frame.

This is the batched rewrite of the reference's `mot_update` hot path
(SURVEY.md §3.2): predict → KCF-detect → associate → correct/retrain →
spawn/kill, with every per-track loop replaced by a bank-wide batched op and
every lifecycle branch replaced by masking.  The only host work per frame
is handing in the frame and padded detections (api.MultiTracker).

Pipeline (matching the reference's per-frame traversal L3→{L1, L2a, L2b}):
  1. Kalman predict (batched)                               [L2a]
  2. KCF detect at predicted ROIs → refined positions        [L1/L0]
  3. IoU (+appearance-from-response) cost, gating            [L2b]
  4. Auction assignment in lax.while_loop                    [L2b]
  5. Matched: KF correct with detection; unmatched with good
     correlation peak: KF correct with the KCF position
     (keeps tracks alive through missed detections)          [L2a]
  6. Births into empty slots from unmatched detections       [L3]
  7. Deaths by age/miss counters                             [L3]
  8. Bank-wide KCF retrain with per-slot learning rate
     (1.0 births, interp matched, 0 dead)                    [L1]
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.ops import features as feat_ops
from jaxmot.ops import fft as fft_ops
from jaxmot.ops import iou as iou_ops
from jaxmot.ops import kalman
from jaxmot.ops import kcf as kcf_ops
from jaxmot.ops import patch as patch_ops
from jaxmot.ops import assignment
from jaxmot.ops.assignment import auction_assign_stats
from jaxmot.tracker import bank as bank_mod
from jaxmot.tracker.bank import CONFIRMED, EMPTY, TENTATIVE, TrackBank


class StepOutput(NamedTuple):
    """Per-frame result, dense over slots (mask with `valid`)."""
    ids: jnp.ndarray          # [T] int32
    boxes: jnp.ndarray        # [T, 4] cx cy w h
    scores: jnp.ndarray       # [T] float32
    valid: jnp.ndarray        # [T] bool — confirmed tracks this frame
    matched_det: jnp.ndarray  # [T] int32 det index or -1
    cls: jnp.ndarray          # [T] int32 track class (0 when detections
                              # carry no class column; -1 empty slots)
    # Observability counters (SURVEY.md §5 metrics): fetched cheaply.
    n_alive: jnp.ndarray      # [] int32
    n_births: jnp.ndarray     # [] int32
    n_deaths: jnp.ndarray     # [] int32
    n_matches: jnp.ndarray    # [] int32
    assign_iters: jnp.ndarray      # [] int32 auction rounds this frame
    assign_converged: jnp.ndarray  # [] bool — False = hit max_iters with a
                                   # partial assignment (surface, don't hide)


def _features_at(frame_gray, boxes, cfg: TrackerConfig, scales=None):
    # Named scopes give the stages stable names in profiler traces.
    with jax.named_scope("roi"):
        patches = patch_ops.extract_patches(
            frame_gray, boxes, cfg.kcf.padding, cfg.kcf.template_size,
            scales=scales)
    with jax.named_scope("features"):
        return feat_ops.extract_features(patches, cfg.kcf)


def _sample_response(response: jnp.ndarray, centers: jnp.ndarray,
                     win: jnp.ndarray, det_centers: jnp.ndarray,
                     size: int) -> jnp.ndarray:
    """Appearance term: read each track's correlation response at each
    detection's location — [T, D] for free from the already-computed
    response maps (the reference evaluates KCF response at detections to
    blend appearance into the cost, BASELINE north star).

    Bilinear sampling as two one-hot weight matmuls,
    v[t, d] = wy[t, d, :] @ response[t] @ wx[t, d, :]ᵀ, rather than
    128·160·4 scalar corner reads.

    response    : [T, S, S]
    centers/win : [T, 2] predicted centers, [T, 2] search window (w, h)
    det_centers : [D, 2]
    """
    # Template coords of detection d in track t's search window.
    rel = (det_centers[None, :, :] - centers[:, None, :])        # [T, D, 2]
    u = rel / jnp.maximum(win[:, None, :], 1e-3) * size + size // 2
    ux = jnp.clip(u[..., 0], 0.0, size - 1.0)                    # [T, D]
    uy = jnp.clip(u[..., 1], 0.0, size - 1.0)
    iota = jnp.arange(size, dtype=jnp.float32)                   # [S]
    # Hat-function weights: nonzero only at the two bracketing pixels.
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(uy[..., None] - iota))   # [T, D, S]
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(ux[..., None] - iota))
    tmp = jnp.einsum("tds,tsx->tdx", wy, response)               # [T, D, S]
    v = jnp.sum(tmp * wx, axis=-1)                               # [T, D]
    inside = ((u[..., 0] >= 0) & (u[..., 0] <= size - 1)
              & (u[..., 1] >= 0) & (u[..., 1] <= size - 1))
    return jnp.where(inside, v, 0.0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def step(bank: TrackBank, frame: jnp.ndarray, dets: jnp.ndarray,
         det_valid: jnp.ndarray, cfg: TrackerConfig
         ) -> tuple[TrackBank, StepOutput]:
    """One frame: returns (new bank, outputs).

    frame     : [H, W] / [H, W, 3] image (uint8 or float).
    dets      : [D, 5] (cx, cy, w, h, score) — or [D, 6] with a detector
                class id as column 5 (see cfg.class_aware) — padded to
                static D.
    det_valid : [D] bool for real detections.
    """
    t_cap = cfg.max_tracks
    s = cfg.kcf.feature_size
    gray = patch_ops.to_gray(frame)
    alive = bank.state > EMPTY
    det_valid = det_valid & (dets[:, 4] >= cfg.det_score_min)
    det_boxes = dets[:, :4]
    # Optional class column (static shape switch — [D, 5] vs [D, 6] trace
    # as different programs, so this costs nothing at runtime).
    det_cls = (jnp.round(dets[:, 5]).astype(jnp.int32)
               if dets.shape[1] >= 6 else jnp.zeros(
                   (dets.shape[0],), jnp.int32))

    # ---- 1. Kalman predict -------------------------------------------
    with jax.named_scope("kalman"):
        kf_mean, kf_cov = kalman.predict(bank.kf_mean, bank.kf_cov,
                                         cfg.kalman)
    pred_boxes = kf_mean[:, :4]

    # ---- 2. KCF detect at predicted ROIs -----------------------------
    # The feature spectra are computed HERE (not inside detect) so (a)
    # the forward-DFT precision class routes per scale — under
    # train_site="detect" only the unit-scale spectrum feeds train()'s
    # divide (step 8 trains from it), so off-scale spectra ride the
    # cheap response class (ops/fft.rfft2 response_class) — and (b) the
    # divide-class unit spectrum is REUSED by step 8 instead of
    # recomputed.
    zf_div = None   # divide-class unit-scale spectrum, reused by step 8
    if cfg.use_kcf:
        with fft_ops.precision_scope(cfg.kcf_precision_resolved), \
                jax.named_scope("kcf_detect"):
            if cfg.kcf.scale_step == 1.0:
                feats = _features_at(gray, pred_boxes, cfg)
                zf_unit = fft_ops.rfft2(
                    feats, response_class=cfg.train_site != "detect")
                response = kcf_ops.detect_from_spectrum(
                    bank.kcf, zf_unit, cfg.kcf.kernel_sigma, s)
            else:
                # 3-level scale pyramid (the C lineage's scale branch):
                # correlate at 1/step, 1, step and keep the best
                # (hysteresis-weighted) peak per track.  The scales fold
                # into the track axis — one [3T]-batched extract — rather
                # than three sequential extract+detect chains
                # (tests/test_tracker.py::
                # test_scale_batched_matches_sequential).  Off-scale
                # spectra only render responses, so they ride the
                # response class as one [2T] batch.
                sstep = cfg.kcf.scale_step
                scale_vals = jnp.asarray([1.0 / sstep, 1.0, sstep],
                                         jnp.float32)
                boxes3 = jnp.tile(pred_boxes, (3, 1))            # [3T, 4]
                scales3 = jnp.repeat(scale_vals, t_cap)          # [3T]
                f3 = _features_at(gray, boxes3, cfg, scales=scales3)
                f3 = f3.reshape((3, t_cap) + f3.shape[1:])       # [3,T,C,S,S]
                zf_off = fft_ops.rfft2(f3[0::2], response_class=True)
                zf_unit = fft_ops.rfft2(
                    f3[1], response_class=cfg.train_site != "detect")
                r_off = kcf_ops.detect_from_spectrum(
                    bank.kcf, zf_off, cfg.kcf.kernel_sigma, s)
                r_unit = kcf_ops.detect_from_spectrum(
                    bank.kcf, zf_unit, cfg.kcf.kernel_sigma, s)
        if cfg.train_site == "detect":
            zf_div = zf_unit
        if cfg.kcf.scale_step == 1.0:
            dy, dx, peak = kcf_ops.peak_displacement(response)
            best_scale = jnp.ones((t_cap,), jnp.float32)
            if cfg.confidence_mode == "psr":
                peak = kcf_ops.psr(response, peak)
        else:
            r3 = jnp.stack([r_off[0], r_unit, r_off[1]])         # [3,T,S,S]
            response = r_unit
            dys, dxs, peaks = kcf_ops.peak_displacement(
                r3.reshape(3 * t_cap, s, s))
            dys = dys.reshape(3, t_cap)                          # [3, T]
            dxs = dxs.reshape(3, t_cap)
            peaks = peaks.reshape(3, t_cap)
            wts = jnp.asarray([cfg.kcf.scale_weight, 1.0,
                               cfg.kcf.scale_weight],
                              jnp.float32)[:, None]
            best = jnp.argmax(peaks * wts, axis=0)               # [T]
            take = lambda a: jnp.take_along_axis(a, best[None], axis=0)[0]
            dy, dx, peak = take(dys), take(dxs), take(peaks)
            best_scale = scale_vals[best]
            if cfg.confidence_mode == "psr":
                # PSR from the unit-scale response (scale selection itself
                # uses raw hysteresis-weighted peaks).
                peak = kcf_ops.psr(response, jnp.max(
                    response.reshape(t_cap, -1), axis=1))
        win = (pred_boxes[:, 2:4] * best_scale[:, None]
               * cfg.kcf.padding)                                # [T, 2]
        kcf_cxy = pred_boxes[:, :2] + jnp.stack(
            [dx, dy], axis=1) * win / s
        # Trust the correlation only for live slots with a solid peak and
        # an in-frame box (a fully clamped patch self-correlates at ~1.0,
        # so in-frame gating is mandatory, not optional).
        h_f, w_f = gray.shape
        in_frame = ((pred_boxes[:, 0] > 0) & (pred_boxes[:, 0] < w_f)
                    & (pred_boxes[:, 1] > 0) & (pred_boxes[:, 1] < h_f))
        kcf_ok = alive & in_frame & (peak >= cfg.confidence_threshold)
        if cfg.train_site == "detect":
            # Detect-site training initializes a birth's model one frame
            # LATE (see step 8): a slot born last frame (age == 1 before
            # this step's increment) holds either zeros or a recycled
            # track's stale spectra — its response is meaningless, so
            # KCF refinement is gated off for that one frame (the track
            # coasts on its Kalman prediction, plain-SORT behavior).
            kcf_ok = kcf_ok & (bank.age != 1)
        kcf_wh = pred_boxes[:, 2:4] * best_scale[:, None]
        refined = jnp.where(kcf_ok[:, None],
                            jnp.concatenate([kcf_cxy, kcf_wh], axis=1),
                            pred_boxes)
    else:
        response = None
        peak = jnp.zeros((t_cap,), jnp.float32)
        kcf_ok = jnp.zeros((t_cap,), bool)
        refined = pred_boxes

    # ---- 3. Cost matrix ----------------------------------------------
    if cfg.use_kcf and cfg.appearance_weight > 0.0:
        appearance = _sample_response(
            response, pred_boxes[:, :2], pred_boxes[:, 2:4] * cfg.kcf.padding,
            det_boxes[:, :2], s)
        if cfg.train_site == "detect":
            # Day-one slots have no model yet (see kcf_ok gate above):
            # zero their rows rather than let stale-spectra responses
            # attract matches.  A uniform per-row shift does not change
            # which detection the row prefers, only its cross-row
            # competitiveness — conservative for a fresh track.
            appearance = appearance * (bank.age != 1)[:, None]
    else:
        appearance = None
    # Class gate (cfg.class_aware): a track only matches detections of
    # its birth class.  Slots with cls < 0 (empty — already masked by
    # `alive`) pass trivially so the gate never interacts with recycling.
    class_gate = ((bank.cls[:, None] == det_cls[None, :])
                  | (bank.cls[:, None] < 0)) if cfg.class_aware else None
    assoc_box = cfg.assoc_box_resolved
    assoc_primary = pred_boxes if assoc_box == "predicted" else refined
    # "best": the Kalman prediction rides along as a second hypothesis
    # per pair (identical when KCF refinement was gated off anyway).
    assoc_alt = pred_boxes if assoc_box == "best" else None
    with jax.named_scope("cost"):
        cost = iou_ops.association_cost(
            assoc_primary, det_boxes, alive, det_valid,
            cfg.iou_gate, cfg.cost_infeasible,
            appearance=appearance, appearance_weight=cfg.appearance_weight,
            class_gate=class_gate, track_boxes_alt=assoc_alt)
    feasible = cost < cfg.cost_infeasible * 0.5

    # ---- 4. Assignment -----------------------------------------------
    # Warm-start the auction with the previous frame's equilibrium
    # prices (exact-safe: the n*eps bound depends only on final eps-CS —
    # see ops/assignment.auction_assign_warm).  Static gate: the carried
    # vector is sized for cfg.max_detections; a caller tracing with a
    # different detection padding falls back to a cold start.
    n_sq = max(t_cap, dets.shape[0])
    warm = cfg.auction_warm_start and bank.auction_prices.shape == (n_sq,)
    if warm:
        (matched_det, assign_iters, assign_conv, new_prices,
         new_col_of) = assignment.auction_assign_warm(
            cost, feasible, bank.auction_prices,
            bank.auction_col_of)                                 # [T]
    else:
        with jax.named_scope("auction"):
            matched_det, assign_iters, assign_conv = auction_assign_stats(
                cost, feasible)                                  # [T]
        new_prices = bank.auction_prices
        new_col_of = bank.auction_col_of
    is_matched = matched_det >= 0
    det_idx = jnp.clip(matched_det, 0, dets.shape[0] - 1)
    det_taken = jnp.zeros((dets.shape[0],), bool).at[
        jnp.where(is_matched, matched_det, dets.shape[0])].set(
            True, mode="drop")

    # ---- 5. Kalman correct -------------------------------------------
    meas_det = det_boxes[det_idx]                                # [T, 4]
    kcf_meas = refined
    use_det = is_matched
    use_kcf_meas = alive & ~is_matched & kcf_ok
    meas = jnp.where(use_det[:, None], meas_det, kcf_meas)
    with jax.named_scope("kalman"):
        kf_mean, kf_cov = kalman.correct(
            kf_mean, kf_cov, meas, use_det | use_kcf_meas, cfg.kalman)

    # ---- 6/7. Lifecycle ----------------------------------------------
    hits = jnp.where(is_matched, bank.hits + 1, bank.hits)
    tsu = jnp.where(is_matched, 0, bank.time_since_update + 1)
    age = jnp.where(alive, bank.age + 1, 0)
    state = bank.state
    state = jnp.where((state == TENTATIVE) & (hits >= cfg.n_init),
                      CONFIRMED, state)
    die = alive & (
        ((state == CONFIRMED) & (tsu > cfg.max_age))
        | ((state == TENTATIVE) & ~is_matched
           & (tsu > cfg.max_age_tentative)))
    n_deaths = jnp.sum(die.astype(jnp.int32))
    state = jnp.where(die, EMPTY, state)

    # Births: unmatched valid detections → lowest-index empty slots.
    empty_slots = state == EMPTY
    free_rank = jnp.cumsum(empty_slots.astype(jnp.int32)) - 1     # [T]
    slot_of_rank = jnp.full((t_cap,), t_cap, jnp.int32).at[
        jnp.where(empty_slots, free_rank, t_cap)].set(
            jnp.arange(t_cap, dtype=jnp.int32), mode="drop")      # [T]
    new_det = det_valid & ~det_taken
    birth_rank = jnp.cumsum(new_det.astype(jnp.int32)) - 1        # [D]
    n_free = jnp.sum(empty_slots.astype(jnp.int32))
    can_birth = new_det & (birth_rank < n_free)
    birth_slot = jnp.where(
        can_birth,
        slot_of_rank[jnp.clip(birth_rank, 0, t_cap - 1)],
        t_cap)                                                    # [D]
    # Scatter detection index into its birth slot.
    slot_birth_det = jnp.full((t_cap,), -1, jnp.int32).at[
        birth_slot].set(jnp.arange(dets.shape[0], dtype=jnp.int32),
                        mode="drop")
    is_birth = slot_birth_det >= 0                                # [T]
    n_births = jnp.sum(is_birth.astype(jnp.int32))
    bdet = jnp.clip(slot_birth_det, 0, dets.shape[0] - 1)
    birth_boxes = det_boxes[bdet]

    init_mean, init_cov = kalman.init(birth_boxes, cfg.kalman)
    kf_mean = jnp.where(is_birth[:, None], init_mean, kf_mean)
    kf_cov = jnp.where(is_birth[:, None, None], init_cov, kf_cov)
    state = jnp.where(is_birth, TENTATIVE, state)
    hits = jnp.where(is_birth, 1, hits)
    tsu = jnp.where(is_birth, 0, tsu)
    age = jnp.where(is_birth, 1, age)
    new_ids = bank.next_id + jnp.where(
        is_birth, jnp.cumsum(is_birth.astype(jnp.int32)) - 1, 0)
    ids = jnp.where(is_birth, new_ids, bank.ids)
    ids = jnp.where(state == EMPTY, -1, ids)
    score = jnp.where(is_birth, dets[bdet, 4], bank.score)
    score = jnp.where(is_matched, dets[det_idx, 4], score)
    # Birth class sticks for the track's lifetime (under class_aware the
    # gate makes every later match agree anyway); empty slots read -1.
    cls = jnp.where(is_birth, det_cls[bdet], bank.cls)
    cls = jnp.where(state == EMPTY, -1, cls)
    next_id = bank.next_id + n_births

    # ---- 8. Bank-wide KCF retrain ------------------------------------
    if cfg.use_kcf and cfg.train_site == "detect":
        # Detect-site training (config.train_site docstring): reuse the
        # step-2 patch spectra, phase-aligned to the corrected centers
        # via the Fourier shift theorem, instead of a second ROI
        # extraction + feature pass at the corrected boxes.  The aligned
        # sample equals the refined-site crop up to circular edge wrap
        # and a window off-center by the (sub-pixel) displacement — a
        # same-frame spatial approximation the Hann window attenuates.
        # The unit-scale divide-class spectrum from step 2 is reused.
        yf = kcf_ops.make_yf(s, cfg.kcf.padding,
                             cfg.kcf.output_sigma_factor)
        win = jnp.maximum(pred_boxes[:, 2:4] * cfg.kcf.padding, 1e-6)
        # Feature-pixel displacement of the corrected center from the
        # extraction (predicted) center: (dx, dy) = delta_px * S / win.
        delta = (kf_mean[:, :2] - pred_boxes[:, :2]) * s / win    # [T, 2]
        d_x, d_y = delta[:, 0], delta[:, 1]
        # Beyond ~S/4 the circular wrap stops being a border effect;
        # skip the EMA update for such jumps (the init overwrite below
        # instead clamps to an unshifted train — it must write SOMETHING
        # usable or the slot would keep stale spectra).
        guard = (jnp.abs(d_x) < s / 4) & (jnp.abs(d_y) < s / 4)
        d_x = jnp.where(guard, d_x, 0.0)
        d_y = jnp.where(guard, d_y, 0.0)
        zf_a = kcf_ops.shift_spectrum(zf_div, d_y, d_x, s)
        # First post-birth frame (born last step: age incremented to 2
        # this step) → lr = 1 full model overwrite; births this frame
        # have no usable sample yet (their box was never extracted) and
        # keep lr = 0 until next step.
        init_now = (state > EMPTY) & (age == 2) & ~is_birth
        lr = jnp.where(
            init_now, 1.0,
            jnp.where((state > EMPTY) & ~is_birth & guard
                      & (is_matched | kcf_ok),
                      cfg.kcf.interp_factor, 0.0))
        with fft_ops.precision_scope(cfg.kcf_precision_resolved), \
                jax.named_scope("kcf_train"):
            new_model = kcf_ops.train_from_spectrum(
                zf_a, yf, cfg.kcf.kernel_sigma, cfg.kcf.lambda_, s)
        kcf_model = kcf_ops.blend(bank.kcf, new_model, lr)
    elif cfg.use_kcf:
        # kf_mean was already overwritten with init_mean (= birth box +
        # zero velocity) at birth slots, so its box block IS the retrain
        # site for births and corrected boxes for survivors.
        final_boxes = kf_mean[:, :4]
        lr = jnp.where(is_birth, 1.0,
                       jnp.where((state > EMPTY) & (is_matched | kcf_ok),
                                 cfg.kcf.interp_factor, 0.0))
        feats_new = _features_at(gray, final_boxes, cfg)
        yf = kcf_ops.make_yf(s, cfg.kcf.padding,
                             cfg.kcf.output_sigma_factor)
        with fft_ops.precision_scope(cfg.kcf_precision_resolved), \
                jax.named_scope("kcf_train"):
            kcf_model = kcf_ops.blend(
                bank.kcf, kcf_ops.train(feats_new, yf, cfg.kcf.kernel_sigma,
                                        cfg.kcf.lambda_), lr)
    else:
        kcf_model = bank.kcf

    new_bank = TrackBank(
        kf_mean=kf_mean, kf_cov=kf_cov, kcf=kcf_model, ids=ids,
        state=state, hits=hits, time_since_update=tsu, age=age,
        score=score, cls=cls, auction_prices=new_prices,
        auction_col_of=new_col_of, next_id=next_id,
        frame_idx=bank.frame_idx + 1)

    out = StepOutput(
        ids=ids,
        boxes=kf_mean[:, :4],
        scores=score,
        valid=((state == CONFIRMED) & (tsu <= cfg.output_max_tsu)),
        matched_det=matched_det,
        cls=cls,
        n_alive=jnp.sum((state > EMPTY).astype(jnp.int32)),
        n_births=n_births,
        n_deaths=n_deaths,
        n_matches=jnp.sum(is_matched.astype(jnp.int32)),
        assign_iters=assign_iters,
        assign_converged=assign_conv,
    )
    return new_bank, out


def init(frame: jnp.ndarray, dets: jnp.ndarray, det_valid: jnp.ndarray,
         cfg: TrackerConfig) -> tuple[TrackBank, StepOutput]:
    """Construct a bank from the first frame's detections — the reference's
    `mot_init` (SURVEY.md §3.1): every valid detection births a track."""
    bank = bank_mod.empty_bank(cfg)
    return step(bank, frame, dets, det_valid, cfg)
