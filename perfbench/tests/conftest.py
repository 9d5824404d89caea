"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
repository root (``PYTHONPATH=src``).  Tests marked ``card`` need a CUDA
card and skip without one; the others run on the CPU at tiny sizes."""
from __future__ import annotations

import dataclasses

import pytest

from perfbench.tests.helpers import tiny_file


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda")


@pytest.fixture
def port_sized(monkeypatch):
    """A mapping name -> configuration file: the port's config of each
    model put in it takes that file's sizes (``launch.serve.serve`` builds
    its config from the arch's name)."""
    import repro_torch.configs as configs
    import repro_torch.launch.serve as serve_mod

    from perfbench.modelspec import spec_of
    from perfbench.program import port_model

    real, files = configs.get_config, {}

    def get_config(name):
        arch = real(name)
        if name not in files:
            return arch
        model = port_model(spec_of(name, files[name]), arch.model)
        return dataclasses.replace(arch, model=model)

    monkeypatch.setattr(configs, "get_config", get_config)
    monkeypatch.setattr(serve_mod, "get_config", get_config)
    return files


@pytest.fixture
def tiny_port(port_sized):
    """The port's config of every configuration in ``BENCHMARK.json`` cut
    to its tiny copy's sizes, keyed by the port's name of it (``arch``)."""
    from perfbench import spec

    for config in spec.load_benchmark()["configs"]:
        file = tiny_file(config["name"])
        port_sized[file["arch"]] = file
