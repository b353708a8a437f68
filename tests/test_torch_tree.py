"""The port's module tree against the JAX package's: every ``*.py`` under
``bbmap_tpu/`` has a counterpart under ``bbmap_tpu_torch/``, under the
same relative name or under the one entry of ``RENAMED`` that names it.
A module that a later change adds to the JAX package shows up here as a
failing test instead of a silent gap."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "bbmap_tpu"
PORT = ROOT / "bbmap_tpu_torch"

# JAX package module -> the port's module that does its work, and why
RENAMED = {
    # the vmapped DP step and the XLA traceback walk are torch code and
    # hand kernels' wrappers in the port, not JAX
    "ops/msa_jax.py": ("ops/msa.py", "the DP batch driver, torch code"),
    # the Pallas kernels become CUDA kernels behind their wrappers
    "ops/msa_pallas.py": ("ops/msa_kernels.py",
                          "the wrappers of the CUDA kernels"),
    # JAX's persistent compile cache: the port compiles no XLA; its
    # compiled code is the CUDA libraries, built once into
    # build/torch_kernels/
    "utils/jaxcfg.py": ("ops/_build.py",
                        "builds the CUDA sources once and caches them"),
}


def _modules(pkg: Path) -> set:
    return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")}


def test_every_jax_module_has_a_port():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT)
    assert len(jax_mods) > 80
    missing = sorted(m for m in jax_mods - port_mods if m not in RENAMED)
    assert not missing, f"JAX modules with no port: {missing}"


def test_renamed_entries_are_exactly_the_renamed_modules():
    """Each entry names a JAX module absent from the port under its own
    name, and a port module that exists; no entry is left over."""
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT)
    assert sorted(jax_mods - port_mods) == sorted(RENAMED)


@pytest.mark.parametrize("jax_mod", sorted(RENAMED))
def test_renamed_counterpart_exists(jax_mod):
    port_mod, reason = RENAMED[jax_mod]
    assert (PORT / port_mod).is_file(), port_mod
    assert (JAX_PKG / jax_mod).is_file(), jax_mod
    assert reason
