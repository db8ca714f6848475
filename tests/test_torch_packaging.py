"""The port's packaging in `pyproject.toml`: a console script for each of
the JAX package's, each naming an importable `main`; an optional
dependency group without JAX; the kernel sources as package data."""

import fnmatch
import importlib
import os
import tomllib

import pytest

from densecap_tpu_torch.ops.cuda import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "pyproject.toml"), "rb") as _f:
    PROJECT = tomllib.load(_f)
SCRIPTS = PROJECT["project"]["scripts"]
PORT = sorted(k for k, v in SCRIPTS.items()
              if v.startswith("densecap_tpu_torch."))


def test_every_jax_script_has_a_port_twin():
    jax = {k for k, v in SCRIPTS.items() if v.startswith("densecap_tpu.")}
    assert jax and set(PORT) == {k.replace("densecap-", "densecap-torch-", 1)
                                 for k in jax}
    for name in PORT:
        twin = SCRIPTS[name.replace("densecap-torch-", "densecap-", 1)]
        assert SCRIPTS[name] == twin.replace("densecap_tpu.",
                                             "densecap_tpu_torch.", 1)


@pytest.mark.parametrize("name", PORT)
def test_port_script_imports_its_main(name):
    module, attr = SCRIPTS[name].split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_port_dependencies_and_kernel_sources():
    deps = PROJECT["project"]["optional-dependencies"]["torch"]
    assert "torch" in deps and not any(d.startswith("jax") for d in deps)
    patterns = PROJECT["tool"]["setuptools"]["package-data"][
        "densecap_tpu_torch.ops.cuda"]
    for src in build.SOURCES + build.HEADERS:
        assert any(fnmatch.fnmatch(src.name, p) for p in patterns), src
