"""Configuration for the MOT framework.

The C++ reference (huangfcn/multiple-object-tracking; mount was empty at survey
time, see SURVEY.md §0) hardcodes its hyper-parameters as compile-time
constants (KCF lambda/sigma/interp factor, patch size, association gates,
track lifecycle ages).  Here every knob lives in one frozen, hashable
dataclass so it can be passed as a jit static argument — the whole per-frame
step specializes on it at trace time, exactly like the reference's #defines
specialize its C code at compile time (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KCFConfig:
    """Hyper-parameters of the KCF correlation-filter core.

    Defaults follow the published KCF raw-pixel configuration
    (arXiv:1404.7584 §8 / Table 1) and the common C++ KCF lineage the
    reference belongs to (SURVEY.md §2 rows fft2d..kcf_detect).
    """

    # Template (patch) size in pixels; BASELINE.json configs[1] fixes 64x64.
    template_size: int = 64
    # Context padding: the tracked window covers padding * target box.
    padding: float = 2.5
    # Ridge-regression regularizer lambda (arXiv:1404.7584 eq. 17).
    lambda_: float = 1e-4
    # Gaussian kernel bandwidth sigma (arXiv:1404.7584 eq. 31).
    kernel_sigma: float = 0.2
    # Desired-response bandwidth: sigma_y = sqrt(h*w) / padding * this.
    output_sigma_factor: float = 0.125
    # Model EMA learning rate ("interp factor" in the C lineage).
    interp_factor: float = 0.075
    # Feature type: "gray" (raw pixels, 1 channel) or "hog" (fHOG, 31
    # channels over cell_size x cell_size cells — the KCF-HOG mode of the
    # reference lineage, arXiv:1404.7584 §8).
    feature_type: str = "gray"
    cell_size: int = 1
    # Multi-scale search: scale step (1.0 disables; 1.05 = +-5% pyramid).
    scale_step: float = 1.0
    # Penalty applied to non-unit scale responses (scale hysteresis).
    scale_weight: float = 0.95

    def __post_init__(self):
        if self.template_size % self.cell_size != 0:
            raise ValueError(
                f"template_size ({self.template_size}) must be a multiple "
                f"of cell_size ({self.cell_size})")
        if self.template_size // self.cell_size < 2:
            raise ValueError(
                "feature_size (template_size // cell_size = "
                f"{self.template_size // self.cell_size}) must be >= 2 — a "
                "1-pixel feature map degenerates the Hann window and FFT")
        if self.feature_type not in ("gray", "hog"):
            raise ValueError(f"unknown feature_type {self.feature_type!r}")
        if self.padding <= 0:
            raise ValueError("padding must be positive")
        if self.scale_step < 1.0:
            raise ValueError("scale_step must be >= 1.0 (1.0 disables)")

    @property
    def feature_size(self) -> int:
        """Spatial extent of the feature map the FFT runs on."""
        return self.template_size // self.cell_size

    @property
    def num_channels(self) -> int:
        return 31 if self.feature_type == "hog" else 1

    @property
    def spectrum_width(self) -> int:
        """Width of the rfft2 half-spectrum."""
        return self.feature_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    """Constant-velocity Kalman filter over box state [cx, cy, w, h, v*4].

    The reference hand-rolls small-matrix KF per track (SURVEY.md §2 row
    "kalman"); noise scales follow the SORT lineage.
    """

    pos_std_factor: float = 1.0 / 20.0   # measurement std ~ box size
    init_vel_cov: float = 1e4            # uninformative velocity prior
    process_pos_std: float = 1.0 / 20.0
    process_vel_std: float = 1.0 / 160.0


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Full MOT pipeline configuration (SURVEY.md §2 row "multitracker")."""

    kcf: KCFConfig = KCFConfig()
    kalman: KalmanConfig = KalmanConfig()

    # Static capacity of the track bank (slots). BASELINE north star: 128.
    max_tracks: int = 128
    # Static per-frame detection capacity (padding target).
    max_detections: int = 64

    # Association.  tools/sweep_defaults.py (occlusion+clutter) and
    # tools/sweep_appearance.py (adversarial bounce/cross fixtures) found
    # the appearance cost blend redundant in this architecture: identical
    # MOTA/IDF1/IDSW at every w in {0..0.7}, because the KCF refinement
    # step injects the same appearance signal upstream (refined boxes sit
    # on the matching texture BEFORE IoU is computed).  The blend stays
    # implemented (ops/iou.association_cost) and CLI-selectable for
    # refinement-off configurations.
    iou_gate: float = 0.3          # min IoU for a feasible match
    appearance_weight: float = 0.0  # cost = (1-w)*(1-IoU) + w*(1-appearance)
    cost_infeasible: float = 1e4   # cost assigned to gated pairs
    # Carry the auction's (prices, matching) across frames and warm-start
    # the next solve (ops/assignment.auction_assign_warm).  Optimality-
    # safe, but on the bench fixture it costs rounds: a gap-bidding
    # auction terminates with every pair at eps-indifference, so per-frame
    # cost noise breaks roughly half the carried pairs and the budgeted
    # warm phase falls back cold (more assign_iters than a cold start,
    # identical MOTA/IDF1/IDSW).  Default off; the flag stays for
    # near-static scenes.
    auction_warm_start: bool = False
    # Class-aware association: detections may carry a class id as a 6th
    # column (dets [D, 6]; models.detector.dets_with_classes builds it).
    # With class_aware=True a track only matches detections of the class
    # it was born with (cross-class pairs are gated infeasible, exactly
    # like the IoU gate), tracks record their class in bank.cls, and
    # StepOutput.cls surfaces it.  Off by default: the reference pipeline
    # tracks a single detector class.  5-column detections under
    # class_aware=True are treated as all class 0 (the gate is trivially
    # true, matching the single-class semantics).
    class_aware: bool = False
    # Which track box hypothesis the association cost scores against the
    # detections: "refined" (the KCF-refined box — the reference blends
    # appearance into association this way), "predicted" (raw Kalman
    # prediction, plain-SORT), or "best" (each pair takes the better IoU
    # of the two — an appearance lock onto a look-alike cannot veto a
    # motion-consistent match; see the identical-texture bounce demo,
    # examples/class_aware_mot.py).  Default "auto" resolves per
    # class_aware (assoc_box_resolved): "refined" single-class, "best"
    # class-aware — the bounce fixture of tests/test_class_aware.py shows
    # class_aware + "refined" in its worst regime (phantom coasting on
    # the gated look-alike) while "best" restores it.
    assoc_box: str = "auto"

    # Lifecycle (SORT-style tentative/confirmed/lost state machine).
    # n_init=2 and max_age_tentative=2 remove one frame of birth delay
    # and give tentative tracks one missed frame of grace (the late-birth
    # gap tools/hota_ceiling.py measures).  n_init=1 collapses under
    # false positives (every FP births an emitted track); at high FP
    # rates the SORT-lineage n_init=3 may be the safer operating point.
    n_init: int = 2                # hits to confirm a tentative track
    max_age: int = 30              # frames unmatched before a track dies
    max_age_tentative: int = 2     # unmatched frames allowed while tentative

    # KCF integration: run correlation detect to refine predicted boxes.
    use_kcf: bool = True
    # Minimum KCF confidence to trust the correlation update; interpreted
    # per confidence_mode: "peak" (raw max response) or "psr"
    # (peak-to-sidelobe ratio, the MOSSE/KCF-lineage measure).  On the
    # occlusion+clutter fixture of tools/sweep_defaults.py psr>=5 lifts
    # MOTA and halves ID switches against an ungated 0.0; PSR is
    # scale-invariant where raw-peak thresholds drift with feature type.
    # None = per-mode validated default (psr: 5.0, peak: 0.35) — a fixed
    # numeric default cannot serve both modes (raw peaks are <= ~1, so a
    # PSR-calibrated 5.0 would silently disable KCF in peak mode).
    min_psr: float | None = None
    confidence_mode: str = "psr"
    # Detection confidence floor.
    det_score_min: float = 0.0

    # Frame geometry (static shapes for jit).
    frame_height: int = 480
    frame_width: int = 640

    # DFT matmul precision of the KCF chain: "auto" (default) |
    # "highest" | "high" | "fwd_high" | "default".  Each mode names the
    # (forward, inverse) dot precisions (ops/fft._MODES).  The forward
    # feature spectra feed train()'s spectral divide, where a rounded
    # operand corrupts alphaf multiplicatively; the inverse transforms
    # only render response surfaces whose sub-pixel peak tolerates it.
    # "auto" resolves to "fwd_high" (kcf_precision_resolved), the mode
    # the identical-texture bounce canary (tools/bounce_fixture.py)
    # must keep at IDF1 >= 0.95 on the accelerator.
    kcf_precision: str = "auto"
    # run_sequence lax.scan unroll factor (>1 lets XLA schedule frame
    # t+1's detection-independent work against frame t's tracker math).
    scan_unroll: int = 1

    # Emit only confirmed tracks seen (matched) within this many frames
    # (SORT emits time_since_update < 1; large value = emit all confirmed
    # including coasting tracks, the KCF-pipeline default).
    output_max_tsu: int = 10 ** 6

    # KCF retrain sample site:
    #   "refined" — re-extract patches at the corrected boxes (the C
    #               lineage's behavior: a second ROI extraction + feature
    #               pass per frame);
    #   "detect"  — reuse the DETECT-site patch spectra, phase-aligned to
    #               the corrected centers in the Fourier domain
    #               (ops/kcf.shift_spectrum): no second extraction at
    #               all.  A spatial approximation within the same frame
    #               (circular edge wrap + window off-center by the
    #               sub-pixel displacement, both attenuated by the Hann
    #               window), NOT a temporal one.  Births initialize one
    #               frame late (lr=1 full overwrite on their first
    #               post-birth frame) and KCF refinement is gated off for
    #               that one frame.
    # Default "detect": on the synthetic fixtures (tools/bench_train_site.py)
    # it matches "refined" on MOTA/IDF1/IDSW and saves the second ROI
    # extraction; detector-outage coasting and mass-birth parity are
    # pinned by tests/test_train_site.py.  "refined" remains the
    # reference-faithful comparison mode.
    train_site: str = "detect"

    def __post_init__(self):
        if self.train_site not in ("refined", "detect"):
            raise ValueError(f"unknown train_site {self.train_site!r}")
        if self.confidence_mode not in ("peak", "psr"):
            raise ValueError(
                f"unknown confidence_mode {self.confidence_mode!r}")
        if self.assoc_box not in ("auto", "refined", "predicted", "best"):
            raise ValueError(f"unknown assoc_box {self.assoc_box!r}")
        if self.kcf_precision not in ("auto", "highest", "high",
                                      "fwd_high", "default"):
            raise ValueError(
                f"unknown kcf_precision {self.kcf_precision!r}")
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if self.max_tracks < 1 or self.max_detections < 1:
            raise ValueError("max_tracks and max_detections must be >= 1")
        if self.frame_height < 1 or self.frame_width < 1:
            raise ValueError("frame dimensions must be positive")

    @property
    def kcf_precision_resolved(self) -> str:
        """kcf_precision with "auto" resolved (see the field comment)."""
        if self.kcf_precision != "auto":
            return self.kcf_precision
        return "fwd_high"

    @property
    def assoc_box_resolved(self) -> str:
        """assoc_box with "auto" resolved per class_aware (see comment)."""
        if self.assoc_box != "auto":
            return self.assoc_box
        return "best" if self.class_aware else "refined"

    @property
    def confidence_threshold(self) -> float:
        """min_psr resolved per confidence_mode (see min_psr comment)."""
        if self.min_psr is not None:
            return self.min_psr
        return 5.0 if self.confidence_mode == "psr" else 0.35

    def replace(self, **kw) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = TrackerConfig()
