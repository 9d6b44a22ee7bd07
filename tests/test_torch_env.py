"""The port's env profile (``repro_torch.launch.env``) against the JAX
package's: the same variables less the two that configure XLA
(``TF_CPP_MIN_LOG_LEVEL``, ``XLA_FLAGS``), the same exports, the same
opt-out, and the shard script's eval line finding the module."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.launch.env as RE
import repro_torch.launch.env as TE

SRC = Path(__file__).resolve().parents[1] / "src"
XLA_ONLY = ("TF_CPP_MIN_LOG_LEVEL", "XLA_FLAGS")


def _without_xla(prof):
    return {k: v for k, v in prof.items() if k not in XLA_ONLY}


BASES = [
    {},
    {"LD_PRELOAD": "/opt/other.so"},
    {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1"},
    {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
     "TF_CPP_MIN_LOG_LEVEL": "0"},
]


@pytest.mark.parametrize("role", ["coordinator", "worker"])
@pytest.mark.parametrize("base", BASES, ids=["empty", "preload", "pinned",
                                             "xla"])
@pytest.mark.parametrize("tcmalloc", [False, True])
def test_profile_equals_the_reference_less_xla(role, base, tcmalloc,
                                               tmp_path, monkeypatch):
    if tcmalloc:
        lib = tmp_path / "libtcmalloc.so.4"
        lib.write_bytes(b"")
        for mod in (RE, TE):
            monkeypatch.setattr(mod, "TCMALLOC_CANDIDATES", (str(lib),))
    monkeypatch.delenv(TE.ENV_PROFILE_ENV, raising=False)
    ref = RE.env_profile(role, base=base)
    port = TE.env_profile(role, base=base)
    assert port == _without_xla(ref)
    assert not set(port) & set(XLA_ONLY)
    assert ("LD_PRELOAD" in port) == (tcmalloc and "LD_PRELOAD" not in base)
    want = "\n".join(line for line in RE.format_exports(role, base=base)
                     .splitlines()
                     if line.split("=")[0][len("export "):] not in XLA_ONLY)
    assert TE.format_exports(role, base=base) == want


def test_unknown_role_and_opt_out(monkeypatch):
    with pytest.raises(ValueError, match="unknown role"):
        TE.env_profile("trainer")
    for off in ("off", "0", "none", "OFF"):
        monkeypatch.setenv(TE.ENV_PROFILE_ENV, off)
        assert TE.format_exports("worker", base={}) == ""
        assert TE.apply_env_profile("worker") == {}


def test_apply_sets_only_what_is_missing(monkeypatch):
    monkeypatch.delenv(TE.ENV_PROFILE_ENV, raising=False)
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                       raising=False)
    monkeypatch.setattr(TE, "TCMALLOC_CANDIDATES", ())
    assert TE.apply_env_profile("worker") == {
        "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
    assert os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == \
        "60000000000"
    assert TE.apply_env_profile("worker") == {}   # a second call changes nil


def test_lazy_exports_of_the_launch_package():
    import repro_torch.launch as launch
    for name in ("apply_env_profile", "env_profile", "format_exports"):
        assert getattr(launch, name) is getattr(TE, name)
    with pytest.raises(AttributeError):
        launch.not_a_name


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in (TE.ENV_PROFILE_ENV,
                        "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")}
    env.update(PYTHONPATH=str(SRC), **extra)
    return env


def test_cli_prints_the_exports_without_runpy_warning():
    out = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "repro_torch.launch.env", "--role", "worker"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr == ""
    assert out.stdout.strip() == TE.format_exports(
        "worker", base={k: v for k, v in _env().items()})


def test_shard_script_eval_line_finds_the_module(tmp_path):
    """The shard script's first step, run by bash as a compute node would:
    the module exists, so the profile lands in the job's environment (the
    eval line's ``|| true`` used to hide that it did not)."""
    from repro_torch.launch.slurm import write_shard_script
    script = write_shard_script(tmp_path, name="s", n_units=1,
                                units_json="u.json", manifest_json="m.json",
                                data_root="/data").read_text()
    line = next(ln for ln in script.splitlines() if ln.startswith("eval "))
    assert "repro_torch.launch.env --role worker" in line
    probe = line.replace(" 2>/dev/null || true", "")
    out = subprocess.run(
        ["bash", "-c", "set -euo pipefail\n" + probe
         + "\necho \"T=${TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD}\""],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "T=60000000000"
