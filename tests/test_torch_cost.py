"""The GPU tail of the port's cost model (``repro_torch.core.cost``:
``GpuEnv``, ``training_run_cost``) against the reference's TPU-pod tail
(``repro/core/cost.py``: ``PodEnv``, ``training_run_cost``): the same
formula, cards for chips, so the same numbers give the same hours and
dollars, exactly. The peak is the roofline's H100 row; no price is
assumed."""
import pytest

from repro.core import cost as ref
from repro_torch.analysis.roofline import H100
from repro_torch.core import cost

CASES = [  # (cards, price a card-hour, peak FLOP/s, model FLOPs, MFU)
    (256, 1.2, 197e12, 7.774646720004096e15, 0.4),
    (8, 2.5, 989e12, 6 * 1.24e9 * 9e12, 0.083),
    (512, 3.0, 989e12, 1e24, 0.55),
    (1, 0.0, 989e12, 1e18, 1.0),
]


@pytest.mark.parametrize("gpus,price,peak,flops,mfu", CASES)
def test_training_run_cost_equals_the_reference(gpus, price, peak, flops,
                                                mfu):
    want = ref.training_run_cost(ref.PodEnv("pod", gpus, price, peak),
                                 flops, mfu)
    got = cost.training_run_cost(cost.GpuEnv("gpus", gpus, price, peak),
                                 flops, mfu)
    assert got["hours"] == want["hours"]
    assert got["dollars"] == want["dollars"]
    assert got["gpu_hours"] == want["hours"] * gpus


def test_peak_is_the_roofline_h100_row():
    env = cost.GpuEnv("one H100", 1, None)
    assert env.peak_flops == H100.peak_flops == 989e12


def test_no_price_gives_hours_and_no_dollars():
    """The price is required and may be None: the hours stand, the
    dollars are not made up."""
    with pytest.raises(TypeError):
        cost.GpuEnv("no price given", 8)
    got = cost.training_run_cost(cost.GpuEnv("x", 8, None), 1e21, 0.4)
    want = cost.training_run_cost(cost.GpuEnv("x", 8, 1.0), 1e21, 0.4)
    assert got["dollars"] is None
    assert got["hours"] == want["hours"] == 1e21 / (8 * 989e12 * 0.4) / 3600
    assert want["dollars"] == want["gpu_hours"]


def test_exported_from_core():
    from repro_torch import core
    assert core.GpuEnv is cost.GpuEnv
    assert core.training_run_cost is cost.training_run_cost
