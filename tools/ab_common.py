"""What the A/B tools share: the card's line and ptxas's figures.

An A/B tool (``tools/torch_*_ab.py``) is run from the root of the checkout
it times, this tree or a parent unpacked beside it, and builds that
checkout's kernels.  It reads ptxas's report of the build with the
``_build.kernel_usage`` of the tree that holds the tool, so that an older
checkout reports its kernels in the same form.
"""

from __future__ import annotations

import importlib.util
import re
import subprocess
from pathlib import Path

__all__ = ["card", "own_kernel_usage", "kernel_entries", "ptxas_usage"]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def own_kernel_usage():
    """kernel_usage from the _build.py of the tree that holds this file."""
    path = Path(__file__).resolve().parents[1] / "binius_ntt_tpu_torch"
    spec = importlib.util.spec_from_file_location("own_build",
                                                  path / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_usage


def kernel_entries(log: str, stem: str) -> list[str]:
    """The mangled names of the entry functions ptxas compiled whose name
    holds a match of the regular expression ``stem``, in the log's order
    (a template instantiation is named by its mangled arguments, as in
    ``butterfly_low_kernelILi4ELb1E`` for ``<4, true>``)."""
    return list(dict.fromkeys(re.findall(
        rf"Compiling entry function '(\w*(?:{stem})\w*)'", log)))


def ptxas_usage(build, stem: str) -> dict:
    """Build the checkout's kernels through its ``_build`` module, print
    ptxas's line for each entry that ``stem`` matches and return them by
    name."""
    build.library()
    log = build.build_info["log"]
    kernel_usage = own_kernel_usage()
    usage = {name: kernel_usage(name, log)
             for name in kernel_entries(log, stem)}
    for name, line in usage.items():
        print(f"[ptxas] {name}: {line or 'not reported'}", flush=True)
    return usage
