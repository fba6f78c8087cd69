"""The port's twin of scripts/profile_train.py on the CPU, at 16^3, f_maps
8, 3 levels: every mode timed and counted, the root script's line
formats, the counters' order across the remat modes and the FLOPs of
the save_convs step against brainfm_tpu_torch/scripts/roofline.py's
count of the same step; an unknown mode is a usage error."""

import re

import pytest
import torch

from brainfm_tpu_torch.scripts import profile_train, roofline


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = ["--size", "16", "--f_maps", "8", "--levels", "3", "--reps", "1",
         "--device", "cpu", "--modes", "off,full,save_convs"]
TIMED = re.compile(r"^(off|full|save_convs) +\d+\.\d ms / step @16\^3 L3 f8$")
LEDGER = re.compile(r"^(off|full|save_convs) +flops +\d+\.\d\d TF   bytes +"
                    r"\d+\.\d\d GiB @16\^3 L3 f8 \((\d+) FLOP, (\d+) B\)$")
PARAMS = re.compile(r"^ {13}params \d+\.\d M -> adamw traffic ~\d+\.\d "
                    r"GB/step \(7 fp32 streams\)$")


def test_timed_modes_print_the_root_lines(capsys):
    assert profile_train.main(SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [TIMED.match(ln).group(1) for ln in lines] == [
        "off", "full", "save_convs"]


@pytest.fixture(scope="module")
def ledger():
    """{mode: (flops, bytes)} parsed from the --ledger lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert profile_train.main(SMALL + ["--ledger"]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 6
    out = {}
    for head, params in zip(lines[::2], lines[1::2]):
        m = LEDGER.match(head)
        assert m, head
        assert PARAMS.match(params), params
        out[m.group(1)] = (int(m.group(2)), int(m.group(3)))
    return out


def test_ledger_flops_count_the_recompute(ledger):
    # FlopCounterMode counts convolutions and matrix products: only full
    # recomputes convolutions in the backward
    assert ledger["full"][0] > ledger["save_convs"][0] == ledger["off"][0]


def test_ledger_bytes_grow_with_the_recompute(ledger):
    # save_convs recomputes the GroupNorm / LeakyReLU chain, full every
    # operation of a block: each recompute reads and writes again
    assert ledger["off"][1] < ledger["save_convs"][1] < ledger["full"][1]


def test_ledger_save_convs_flops_equal_the_roofline_count(ledger):
    cfg = profile_train.step_cfg(16, 8, 3, "save_convs")
    dev = torch.device("cpu")
    torch.manual_seed(0)
    total, _ = roofline.step_flops(cfg, profile_train.root_batch(16, dev),
                                   dev)
    assert total == ledger["save_convs"][0]


def test_unknown_mode_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        profile_train.main(["--modes", "full,sometimes"])
    assert e.value.code == 2
    assert "unknown --modes ['sometimes']" in capsys.readouterr().err


def test_a_failing_mode_prints_failed_and_the_sweep_goes_on(monkeypatch,
                                                            capsys):
    real = profile_train.time_mode

    def oom_off(cfg, batch, dev, reps):
        if cfg.remat is False:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(cfg, batch, dev, reps)

    monkeypatch.setattr(profile_train, "time_mode", oom_off)
    assert profile_train.main(SMALL[:-1] + ["off,save_convs"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("off          FAILED: OutOfMemoryError: CUDA out of "
                        "memory (test)")
    assert [TIMED.match(ln).group(1) for ln in lines[1:]] == ["save_convs"]
