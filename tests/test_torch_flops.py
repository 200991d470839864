"""PyTorch port, the last core utilities against the JAX package, on the
CPU: ``core/flops.py``'s decode_flops, param_count, decode_step_bytes and
roofline equal the JAX package's for every preset (roofline with both
peaks given: the port has no default peaks), and ``core/metrics.py``'s
StepTimer."""

import time

import pytest
import torch

from vag_nmt_tpu.core import flops as jflops
from vag_nmt_tpu.core.config import PRESETS as JAX_PRESETS

from vag_nmt_tpu_torch.core import flops
from vag_nmt_tpu_torch.core.config import PRESETS
from vag_nmt_tpu_torch.core.metrics import StepTimer


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_flops_and_bytes_match_jax(name):
    cfg, jcfg = PRESETS[name], JAX_PRESETS[name]
    assert flops.param_count(cfg.model) == jflops.param_count(jcfg.model)
    for T in (8, 24, 128):
        for rows, dtb in ((1, 4), (640, 2), (5120, 4)):
            assert flops.decode_step_bytes(cfg.model, rows, T, dtb) == \
                jflops.decode_step_bytes(jcfg.model, rows, T, dtb)
        assert flops.decode_step_bytes(cfg.model, 7, T) == \
            jflops.decode_step_bytes(jcfg.model, 7, T)
        for n, K, steps in ((1024, 5, 17.25), (1, 1, 3.0), (512, 12, 96.0)):
            assert flops.decode_flops(cfg, n, K, T, steps) == \
                jflops.decode_flops(jcfg, n, K, T, steps)


ROOF_POINTS = [(1e12, 1e9), (4e14, 1e9), (1e12, 2e12), (5e14, 2.5e12),
               (2e13, 1e11), (0.0, 0.0), (3e13, 4e11)]


@pytest.mark.parametrize("point", ROOF_POINTS)
def test_roofline_matches_jax_with_its_peaks(point):
    for peaks in ((jflops.V5E_PEAK_BF16_FLOPS, jflops.V5E_HBM_BYTES_PER_S),
                  (flops.H100_PEAK_TF32_FLOPS, flops.H100_HBM_BYTES_PER_S),
                  (flops.H100_PEAK_BF16_FLOPS, flops.H100_HBM_BYTES_PER_S)):
        assert flops.roofline(*point, *peaks) == jflops.roofline(*point,
                                                                 *peaks)


def test_roofline_takes_no_default_peaks():
    with pytest.raises(TypeError):
        flops.roofline(1e12, 1e9)


def test_step_timer_on_the_cpu():
    t = StepTimer()
    t.start()
    time.sleep(0.02)
    x = torch.ones(3) * 2
    dt = t.stop(x, torch.zeros(2))
    assert 0.02 <= dt < 5.0
    t.start()
    assert t.stop() < dt
