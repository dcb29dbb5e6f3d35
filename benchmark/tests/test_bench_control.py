"""The control: the reference one precision step below the configuration,
in the program's place, comes out not correct. On the CPU at a tiny size
for the fast level's fp8 step; the exact level's TF32 step needs the
card."""

from conftest import tiny_root

from control import control_numbers


def test_fp8_control_is_not_correct(tmp_path):
    numbers, _, correct = control_numbers("tuinet.backlog_quiet", 2 ** 31 + 3, "cpu",
                                          root=tiny_root(tmp_path))
    assert numbers["recordings_checked"] == 2 and not correct, numbers


def test_tf32_control_is_not_correct(tmp_path, cuda):
    numbers, _, correct = control_numbers("effnetb0.cli_exact", 2 ** 31 + 3, "cuda",
                                          root=tiny_root(tmp_path))
    assert numbers["recordings_checked"] == 2 and not correct, numbers
