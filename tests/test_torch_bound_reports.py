"""``fpv_tpu_torch.ops.rans_bound``'s reports against the JAX module's.

Each report runs on the CPU at one block and one timed round (the plain
versions; its times are the CPU's and are not compared) beside the JAX
module's report at the same size (Pallas in interpret mode): the same
keys, the same integer fields, and the same measured stream sizes.  The
one integer that differs by design is ``grid_cells``: the port counts
CTAs (one per block), the TPU grid cells of NSUB_DEC blocks.
"""

import pytest

from fpv_tpu.ops import rans_bound as jbound
from fpv_tpu.ops import rans_pallas as rp
from fpv_tpu_torch.ops import rans_bound as tbound

REPORTS = ["bound_report", "nsub_report", "nsub_encode_report",
           "fused_rows_report", "class_tables_report"]


@pytest.mark.parametrize("name", REPORTS)
def test_report_matches_jax(name):
    got = getattr(tbound, name)(nblocks=1, reps=1, device="cpu")
    want = getattr(jbound, name)(nblocks=1, reps=1)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        if key == "grid_cells":
            assert got[key] == 1 and v == 1 // rp.NSUB_DEC
        elif isinstance(v, int) or key.endswith("_bits_per_byte"):
            assert got[key] == v, key
        else:
            assert isinstance(got[key], float) and got[key] > 0, key


def test_reports_default_to_the_card_and_main_takes_device(capsys,
                                                          monkeypatch):
    """Without a card the reports raise unless asked for the CPU; the
    module's command line takes --device and prints the report."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbound.bound_report(nblocks=1, reps=1)
    monkeypatch.setitem(tbound.REPORTS, "tiny",
                        lambda device: {"device": str(device)})
    tbound.main(["tiny", "--device", "cpu"])
    assert '"device": "cpu"' in capsys.readouterr().out
