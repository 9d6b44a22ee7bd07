"""The Mamba-2 glue kernels' plain versions and the layer's fused path, on
the CPU.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``; their
source runs here through the shim, ``test_torch_mamba2_glue_shim.py``).
Here the plain versions stand for them: the layer's glue taken through
``mamba2_conv_in`` and ``mamba2_gate_norm`` (the fused path forced on the
CPU, where the wrappers run the plain versions) gives the torch ops of the
other paths bit for bit: the layer's output, both states and K6's inputs.
Tolerance: none. The fused path engages only for a bf16 serving prefill on
the card with the whole of d_inner on the rank; decode, training, a group
of more than one rank, f32 and the CPU keep the other path.
"""
import types

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mamba2_glue as glue
from repro_torch.models import mamba2 as TM

CFG = get_config("zamba2-1.2b").reduced()


def _layer(dtype, seed=0):
    """One reduced zamba2 layer's weights in ``dtype``, with the bias, D,
    dt_bias and norm drawn (their init is ones or zeros)."""
    g = torch.Generator().manual_seed(seed)
    p = TM.init_mamba_layer(g, CFG, 1, dtype=torch.float32, device="cpu")
    p = {k: v[0] for k, v in p.items()}
    for k, (loc, sd) in {"conv_b": (0, 0.3), "dt_bias": (0, 0.5),
                         "D": (1, 0.5), "norm": (1, 0.2)}.items():
        p[k] = loc + sd * torch.randn(p[k].shape, generator=g)
    return {k: v.to(dtype) for k, v in p.items()}


def _state(B, dtype, given: bool, seed=1):
    if not given:
        return None
    g = torch.Generator().manual_seed(seed)
    st = TM.init_mamba_state(CFG, 1, B, dtype, "cpu")
    return {"ssm": torch.randn(st["ssm"][0].shape, generator=g),
            "conv": torch.randn(st["conv"][0].shape, generator=g).to(dtype)}


def _run(monkeypatch, x, p, st, fused: bool):
    """mamba_block with the fused path forced on or off; returns (output,
    state, K6's inputs)."""
    seen = []
    real = TM.ssd_chunked_op

    def scan(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(TM, "ssd_chunked_op", scan)
        m.setattr(TM, "_glue_kernels", lambda *a: fused)
        with torch.no_grad():
            out, new = TM.mamba_block(x, p, CFG, st)
    return out, new, seen[0]


@pytest.mark.parametrize("S", [2, 5, 150])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("dtype,pdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_fused_path_is_the_torch_ops_bit_for_bit(monkeypatch, S, given,
                                                 dtype, pdtype):
    """The layer through the plain versions of the two kernels against the
    torch ops of the other paths: the output, the SSM and conv states, and
    K6's four inputs (xs, lw, B, C) bit-equal, with and without a given
    state, at a length shorter than the conv window, one chunk and three
    (ragged)."""
    g = torch.Generator().manual_seed(S)
    x = torch.randn(2, S, CFG.d_model, generator=g).to(dtype)
    p, st = _layer(pdtype), _state(2, dtype, given)
    want, ws, wk6 = _run(monkeypatch, x, p, st, fused=False)
    got, gs, gk6 = _run(monkeypatch, x, p, st, fused=True)
    assert torch.equal(got, want)
    assert torch.equal(gs["ssm"], ws["ssm"])
    assert torch.equal(gs["conv"], ws["conv"])
    for a, b in zip(gk6, wk6):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On a CPU tensor each wrapper is its plain version, and counts no
    launch."""
    glue.reset_launches()
    di, N, H = 256, 16, 8
    g = torch.Generator().manual_seed(0)
    proj = torch.randn(2, 9, 2 * di + 2 * N + H, generator=g).to(
        torch.bfloat16)
    z, conv, dt = torch.split(proj, [di, di + 2 * N, H], -1)
    p = _layer(torch.bfloat16)
    args = (conv, dt, None, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])
    got = glue.mamba2_conv_in(*args, d_state=N)
    want = glue.mamba2_conv_in_plain(*args, d_state=N)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y = torch.randn(2, 9, H, di // H, generator=g)
    assert torch.equal(glue.mamba2_gate_norm(y, got[4], z, p["D"], p["norm"]),
                       glue.mamba2_gate_norm_plain(y, got[4], z, p["D"],
                                                   p["norm"]))
    assert dict(glue.LAUNCHES) == {"mamba2_conv_in": 0,
                                   "mamba2_gate_norm": 0}


def test_wrappers_refuse_inputs_that_require_grad():
    """Under grad mode, on the CPU as on the card; under no_grad they run."""
    di, N, H = 256, 16, 8
    proj = torch.randn(1, 4, 2 * di + 2 * N + H)
    z, conv, dt = torch.split(proj, [di, di + 2 * N, H], -1)
    p = {k: v.requires_grad_(True) for k, v in _layer(torch.float32).items()}
    args = (conv, dt, None, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])
    with pytest.raises(RuntimeError, match="mamba2_conv_in: an input "
                                           "requires grad"):
        glue.mamba2_conv_in(*args, d_state=N)
    y = torch.randn(1, 4, H, di // H)
    with pytest.raises(RuntimeError, match="mamba2_gate_norm: an input "
                                           "requires grad"):
        glue.mamba2_gate_norm(y, conv[..., :di], z, p["D"], p["norm"])
    with torch.no_grad():
        glue.mamba2_conv_in(*args, d_state=N)
        glue.mamba2_gate_norm(y, conv[..., :di], z, p["D"], p["norm"])


def test_wrappers_refuse_widths_they_do_not_take():
    """d_state off the 8-channel groups, heads of 12 channels, a conv of 5
    taps, mismatched shapes: a ValueError, on the CPU too."""
    p = _layer(torch.float32)
    di, N, H = 256, 16, 8

    def conv_in(C, H, K=4, S=4, d_state=N):
        proj = torch.zeros(1, S, C + H)
        return glue.mamba2_conv_in(
            proj[..., :C], proj[..., C:], None, torch.zeros(K, C),
            torch.zeros(C), torch.zeros(H), torch.zeros(H), d_state=d_state)
    conv_in(di + 2 * N, H)
    with pytest.raises(ValueError):
        conv_in(di + 2 * 12, H, d_state=12)
    with pytest.raises(ValueError):
        conv_in(240 + 2 * N, 20)                # 12 channels a head
    with pytest.raises(ValueError):
        conv_in(di + 2 * N, H, K=5)
    with pytest.raises(ValueError):
        glue.mamba2_gate_norm(torch.zeros(1, 4, H, di // H),
                              torch.zeros(1, 4, di), torch.zeros(1, 4, di),
                              p["D"][:4], p["norm"])


def _h(is_cuda=True, dtype=torch.bfloat16, S=64):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 shape=(2, S, CFG.d_model))


@pytest.mark.parametrize("case,want", [
    ("serving prefill", True), ("group of one", True), ("cpu", False),
    ("f32", False), ("train", False), ("decode", False),
    ("group of two", False), ("widths", False)])
def test_fused_path_engages_only_on_a_bf16_card_prefill(case, want):
    """What :func:`_glue_kernels` reads of its input: a CUDA bf16 tensor of
    more than one token, not training, no group or one of one rank, widths
    the kernels take; each other case keeps the torch ops."""
    cfg, train, grp = CFG, False, None
    h = _h()
    if case == "group of one":
        grp = types.SimpleNamespace(size=1)
    elif case == "cpu":
        h = _h(is_cuda=False)
    elif case == "f32":
        h = _h(dtype=torch.float32)
    elif case == "train":
        train = True
    elif case == "decode":
        h = _h(S=1)
    elif case == "group of two":
        grp = types.SimpleNamespace(size=2)
    elif case == "widths":
        import dataclasses
        cfg = dataclasses.replace(CFG, ssm=dataclasses.replace(
            CFG.ssm, d_state=12))
    assert TM._glue_kernels(h, cfg, train, grp) is want


def test_takes_the_published_and_reduced_widths():
    for cfg in (get_config("zamba2-1.2b"), CFG):
        s = cfg.ssm
        di = s.expand * cfg.d_model
        assert glue.takes(di, s.d_state, di // s.d_head, s.d_conv)
    assert not glue.takes(4096, 64, 4, 4)        # rows off 16 bytes
    assert not glue.takes(4096, 64, 64, 5)
