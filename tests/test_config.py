"""Config validation (__post_init__) + host-pipeline error-path tests."""

import numpy as np
import pytest

from jaxmot.config import KCFConfig, TrackerConfig


def test_valid_defaults_construct():
    TrackerConfig()
    KCFConfig(feature_type="hog", cell_size=4)


@pytest.mark.parametrize("kw", [
    dict(cell_size=3),                      # 64 % 3 != 0
    dict(template_size=4, cell_size=4),     # feature_size == 1 (hann2d)
    dict(feature_type="sift"),
    dict(padding=0.0),
    dict(scale_step=0.9),
])
def test_bad_kcf_config_rejected(kw):
    with pytest.raises(ValueError):
        KCFConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(confidence_mode="apce"),
    dict(scan_unroll=0),
    dict(max_tracks=0),
    dict(frame_height=0),
])
def test_bad_tracker_config_rejected(kw):
    with pytest.raises(ValueError):
        TrackerConfig(**kw)


def test_video_pipeline_propagates_decode_errors():
    """A mid-stream decode failure must raise in the consumer, not look
    like a clean EOF."""
    from jaxmot.data.video import ChunkedVideoPipeline

    def frames():
        yield np.zeros((8, 8), np.uint8)
        yield np.zeros((8, 8), np.uint8)
        raise OSError("decoder died mid-stream")

    pipe = ChunkedVideoPipeline(frames(), chunk=2)
    it = iter(pipe)
    next(it)                    # first full chunk arrives fine
    with pytest.raises(OSError, match="decoder died"):
        list(it)


def test_cli_synthetic_defaults_frames():
    """CLAUDE.md quickstart `mot --synthetic --score` must run without
    --frames (it used to crash with TypeError)."""
    from jaxmot.cli import main
    rc = main(["mot", "--synthetic", "--score", "--no-kcf",
               "--max-tracks", "8", "--max-dets", "8", "--objects", "2",
               "--chunk", "25"])
    assert rc == 0


def test_kcf_precision_auto_resolution():
    """kcf_precision="auto" resolves to "fwd_high" (forward feature DFTs
    at HIGH for the spectral divide; inverse response DFTs at DEFAULT);
    explicit settings pass through and unknown modes are rejected."""
    from jaxmot.config import TrackerConfig

    assert TrackerConfig().kcf_precision == "auto"
    assert TrackerConfig().kcf_precision_resolved == "fwd_high"
    # Explicit settings win over the coupling.
    assert (TrackerConfig(kcf_precision="default").kcf_precision_resolved
            == "default")
    for mode in ("highest", "high", "fwd_high"):
        assert TrackerConfig(kcf_precision=mode).kcf_precision_resolved \
            == mode
    with pytest.raises(ValueError, match="unknown kcf_precision"):
        TrackerConfig(kcf_precision="bf16")


def test_fft_precision_scope_modes():
    """precision_scope pins the (fwd, inv) einsum precisions at trace
    time and restores on exit; unknown modes are rejected."""
    from jaxmot.ops import fft as fft_ops

    assert fft_ops.get_default_precision() == "highest"
    with fft_ops.precision_scope("fwd_high"):
        assert fft_ops.get_default_precision() == "fwd_high"
        with fft_ops.precision_scope("default"):
            assert fft_ops.get_default_precision() == "default"
        assert fft_ops.get_default_precision() == "fwd_high"
    assert fft_ops.get_default_precision() == "highest"
    with pytest.raises(ValueError, match="unknown fft precision"):
        fft_ops.precision_scope("bf16").__enter__()
