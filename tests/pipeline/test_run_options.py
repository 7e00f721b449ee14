"""Run-wide options: the device-routing CLI flags, the cohort-size tuning
(applied once per run), and multi-process device pinning."""

import pytest

from graphtyper_tpu.cli import _options_from_args, build_parser
from graphtyper_tpu.config import DEFAULT_OPTIONS, current_options, replace, set_options


@pytest.mark.parametrize(
    "flags, want",
    [
        ([], dict(device_align="auto", device_seed="auto", device_discovery="auto")),
        (
            ["--device_align", "verify", "--device_seed", "on", "--device_discovery", "off"],
            dict(device_align="verify", device_seed="on", device_discovery="off"),
        ),
    ],
)
def test_device_routing_flags(flags, want):
    args = build_parser().parse_args(["genotype", "ref.fa", "--sam", "a.bam", *flags])
    opts = _options_from_args(args)
    assert {k: getattr(opts, k) for k in want} == want


def test_cohort_tuning_applies_once():
    from graphtyper_tpu.pipeline.genotype import apply_cohort_size_tuning

    old = current_options()
    try:
        set_options(DEFAULT_OPTIONS)
        apply_cohort_size_tuning(50)
        once = current_options()
        apply_cohort_size_tuning(50)  # a second region line of the same run
        assert current_options() is once
        assert once.genotype_aln_min_support == DEFAULT_OPTIONS.genotype_aln_min_support + 1
        set_options(replace(DEFAULT_OPTIONS, threads=2))  # a new run tunes again
        apply_cohort_size_tuning(50)
        assert current_options().genotype_aln_min_support == once.genotype_aln_min_support
    finally:
        set_options(old)


def test_initialize_pins_local_devices(monkeypatch):
    import jax

    from graphtyper_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(kw))
    monkeypatch.setattr(jax, "devices", lambda: seen.setdefault("backend_up", True))
    distributed.initialize("localhost:1234", 4, 2, local_device_ids=[2])
    assert seen == dict(
        coordinator_address="localhost:1234", num_processes=4, process_id=2, local_device_ids=[2],
        backend_up=True,
    )
    seen.clear()
    distributed.initialize("localhost:1234", 1, 0)  # one process: nothing to bring up
    assert seen == {}
