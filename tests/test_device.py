"""The one platform choice (boltzfft.device.pipeline_choice) and the CLI's
``--impl auto`` that reads it."""

import pytest

import boltzfft as bz


@pytest.mark.parametrize(
    "backend,impl,engine", [("cpu", "rfft", "vpu"), ("gpu", "rfft", "vpu")]
)
def test_choice_per_backend(backend, impl, engine):
    choice = bz.pipeline_choice(backend)
    assert choice == bz.PipelineChoice(impl=impl, ds_contract=engine)
    # every choice is a valid configuration
    bz.CollisionConfig(nv=8, ns=6, impl=choice.impl)


@pytest.mark.parametrize("backend", ["neuron", "rocm", "METAL"])
def test_unknown_backend_is_an_error(backend):
    with pytest.raises(ValueError, match="no pipeline choice"):
        bz.pipeline_choice(backend)


def test_default_reads_jax_backend(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert bz.pipeline_choice() == bz.pipeline_choice("gpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    with pytest.raises(ValueError):
        bz.pipeline_choice()


def test_cli_auto_impl_follows_choice(monkeypatch):
    from boltzfft.cli import resolve_impl

    assert resolve_impl("auto") == bz.pipeline_choice().impl
    assert resolve_impl("c2c") == "c2c"


@pytest.mark.parametrize(
    "argv", [["--impl", "fused"], ["--ds-contract", "ozk"],
             ["--gmain-fused", "3"]]
)
def test_cli_rejects_removed_options(argv):
    from boltzfft.cli.maxwell_bkw import main

    with pytest.raises(SystemExit):
        main(["--Nv", "8", "--Ns", "6"] + argv)
