"""Allocator environment profile for coordinator and worker processes — the
launch-script hygiene of a deployment's ``run.sh``, folded into the tree so
``python -m repro_torch.dist.rpc serve|work`` applies it without a wrapper
script, and the SLURM shard template evals it on the compute node.

What the profile sets (and why):

* ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD`` — silence tcmalloc's
  large-allocation warnings for the multi-hundred-MB image volumes the
  pipelines routinely allocate; the reports are stderr noise at best and a
  per-allocation slowdown at worst.
* ``LD_PRELOAD`` → tcmalloc, when a known ``libtcmalloc`` exists on the
  host. A dynamic linker option can only take effect at process start, so
  :func:`apply_env_profile` exports it for *children* (the worker
  subprocesses a coordinator or launcher spawns) while
  :func:`format_exports` emits it for shell scripts that can set it before
  exec — the SLURM shard template evals the latter on the compute node.

The reference's profile also sets ``TF_CPP_MIN_LOG_LEVEL`` and
``XLA_FLAGS``; both configure XLA, which the port never loads, so they are
left out. No CUDA variable takes their place here: a CUDA profile belongs
with the port's distributed training launcher (ROADMAP.md, Queue 1 item 4).

Everything is fail-soft and override-safe: variables the process already
has keep their values, a missing tcmalloc just drops the preload, and
``REPRO_ENV_PROFILE=off`` disables the whole profile.
"""
from __future__ import annotations

import os
import shlex
from typing import Dict, Mapping, Optional

ENV_PROFILE_ENV = "REPRO_ENV_PROFILE"     # "off"/"0"/"none" disables

ROLES = ("coordinator", "worker")

# allocator hygiene, identical for both roles
_COMMON = {
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

# well-known tcmalloc locations (Debian/Ubuntu full + minimal builds);
# first hit wins, no hit = no preload
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)


def _find_tcmalloc() -> Optional[str]:
    for cand in TCMALLOC_CANDIDATES:
        if os.path.exists(cand):
            return cand
    return None


def env_profile(role: str = "worker",
                base: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """The variables the profile would set for ``role``, given the current
    (or a supplied) environment — only the ones that change: anything the
    environment already pins is left out."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r} (want one of {ROLES})")
    base = os.environ if base is None else base
    out: Dict[str, str] = {}
    for k, v in _COMMON.items():
        if k not in base:
            out[k] = v
    if "LD_PRELOAD" not in base:
        tcm = _find_tcmalloc()
        if tcm is not None:
            out["LD_PRELOAD"] = tcm
    return out


def _disabled() -> bool:
    return os.environ.get(ENV_PROFILE_ENV, "").lower() in ("off", "0", "none")


def apply_env_profile(role: str = "worker") -> Dict[str, str]:
    """Apply the profile to ``os.environ``. Returns what was set.
    ``LD_PRELOAD`` set here cannot re-link the *current* process (the
    dynamic linker already ran); it still reaches every child process, which
    is where workers and their pipelines run. No-op when
    ``REPRO_ENV_PROFILE`` disables it."""
    if _disabled():
        return {}
    prof = env_profile(role)
    os.environ.update(prof)
    return prof


def format_exports(role: str = "worker",
                   base: Optional[Mapping[str, str]] = None) -> str:
    """The profile as ``export K=V`` shell lines (values quoted) — for
    launch scripts, where ``LD_PRELOAD`` can take effect before the python
    process starts. Empty string when the profile is disabled."""
    if _disabled():
        return ""
    prof = env_profile(role, base=base)
    return "\n".join(f"export {k}={shlex.quote(v)}"
                     for k, v in sorted(prof.items()))


def _main():
    import argparse
    ap = argparse.ArgumentParser(
        description="print the repro_torch env profile as shell export lines "
                    "(eval \"$(python -m repro_torch.launch.env --role "
                    "worker)\")")
    ap.add_argument("--role", default="worker", choices=ROLES)
    args = ap.parse_args()
    exports = format_exports(args.role)
    if exports:
        print(exports)


if __name__ == "__main__":
    _main()
