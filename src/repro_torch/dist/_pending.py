"""The parts of the reference's ``dist/`` and ``launch/`` that the port does
not have yet: the socket transport (``dist/rpc.py``), the peer blob fabric
(``dist/blobserve.py``), the chaos proxy (``dist/faults.py``), the pod
launcher of ``launch/slurm.py`` and ``launch/env.py``. A setting that needs
one of them raises :func:`not_ported` instead of quietly running without it.
"""
from __future__ import annotations


def not_ported(what: str, module: str) -> NotImplementedError:
    """The error a setting raises while ``module`` is missing from the port."""
    return NotImplementedError(
        f"{what} needs {module}, which the port does not have yet: it "
        "arrives with the socket half of dist/ (ROADMAP.md, Queue 1 item 3b)")
