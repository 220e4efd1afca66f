"""``tracer.seed_kernel_share`` reads the program's seed counters: the
share of its ``initialize`` calls that launched the seed kernel, and
nothing from a program without the counters or before it seeded."""

from types import SimpleNamespace

import pytest

from portbench import spec


@pytest.fixture
def counters(monkeypatch):
    from rwrt_tpu_torch import tracer

    monkeypatch.setattr(tracer, "SEED_LAUNCHES", 30)
    monkeypatch.setattr(tracer, "SEED_CALLS", 40)
    return tracer


def test_the_share_of_the_calls_that_launched(counters, monkeypatch):
    read = spec.reader("tracer.seed_kernel_share")
    assert read(SimpleNamespace()) == 0.75
    monkeypatch.setattr(counters, "SEED_LAUNCHES", 40)
    assert read(SimpleNamespace()) == 1.0


@pytest.mark.parametrize("name", ["SEED_LAUNCHES", "SEED_CALLS"])
def test_nothing_without_the_counters(counters, monkeypatch, name):
    read = spec.reader("tracer.seed_kernel_share")
    monkeypatch.delattr(counters, name)
    assert read(SimpleNamespace()) is None


def test_nothing_before_a_seed(counters, monkeypatch):
    read = spec.reader("tracer.seed_kernel_share")
    monkeypatch.setattr(counters, "SEED_LAUNCHES", 0)
    monkeypatch.setattr(counters, "SEED_CALLS", 0)
    assert read(SimpleNamespace()) is None
