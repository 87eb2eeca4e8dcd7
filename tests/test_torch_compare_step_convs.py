"""``tools/compare_step_convs.py`` reads phase 8 of ``chip_smoke.py`` logs,
in the format before and after the split and TFLOP/s columns, and tabulates
the mean time per distinct conv.  Nothing here needs a card."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import compare_step_convs as csc  # noqa: E402

OLD = """[7 backward kernels, synthetic maps] level rows {1: 51028}
       stem K=125   3->32  rows 51028->51028  kernel/plain fwd 9.0/9.0 ms (1e-07)
[8 backward kernels, training-step maps] 3 conv calls
      call0 K=125   3->32  rows 51028->51028  kernel/plain fwd 0.2728/6.0200 ms (6.8e-07)  dw 1.0893/6.0997 ms (5.5e-07)
     call1 K=27   96->96  rows 51028->51028  kernel/plain fwd 1.6000/2.4000 ms (5e-07)  dx 1.7000/2.5000 ms (5e-07)  dw 2.9000/2.3000 ms (5e-07)
     call2 K=27   96->96  rows 51028->51028  kernel/plain fwd 1.8000/2.6000 ms (5e-07)  dx 1.7000/2.5000 ms (5e-07)  dw 2.9000/2.3000 ms (5e-07)
  sum over one step, K1 forward: kernel 3.673 ms, plain 11.022 ms
"""
NEW = OLD.replace(
    "dw 2.9000/2.3000 ms (5e-07)", "dw 0.9000/2.3000 ms (5e-07, S=10, 18.34 TFLOP/s)"
)


def test_step_calls_parse_both_formats():
    for text, dw in ((OLD, 2.9), (NEW, 0.9)):
        calls = csc.step_calls(text)
        assert [c for c, _ in calls] == [(125, 3, 32, 51028, 51028)] + [(27, 96, 96, 51028, 51028)] * 2
        assert "dx" not in calls[0][1] and calls[1][1]["dw"] == (dw, 2.3)


def test_table_means_and_sums(tmp_path):
    old, new = tmp_path / "old.txt", tmp_path / "new.txt"
    old.write_text(OLD)
    new.write_text(NEW)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "compare_step_convs.py"), f"parent={old}", f"change={new}"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    assert out[0].startswith("| K | Cin→Cout | rows in→out | calls | fwd parent | fwd change |")
    row = next(line for line in out if line.startswith("| 27 | 96→96 |"))
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[3] == "2"  # calls
    assert cells[4:6] == ["1.7000 / 2.5000"] * 2  # forward, mean of two calls
    assert cells[8:10] == ["2.9000 / 2.3000", "0.9000 / 2.3000"]  # dW, parent and change
    assert out[-1].split("|")[5].strip() == "3.673 / 11.020"  # forward sum, parent
