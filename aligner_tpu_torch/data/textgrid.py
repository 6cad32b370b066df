"""Praat TextGrid export, the standard interchange format for forced
alignments (pure Python, copied from aligner_tpu/data/textgrid.py).
Converts per-token frame durations (from `aligner-tpu-torch align` or
`durations_from_path`) into an IntervalTier of token segments."""
from __future__ import annotations

from collections.abc import Sequence


def durations_to_intervals(durations: Sequence[int], labels: Sequence[str],
                           hop_length: int, sample_rate: int):
    """[(start_s, end_s, label), ...] from frame durations."""
    spf = hop_length / sample_rate
    out = []
    t = 0.0
    for d, lab in zip(durations, labels):
        out.append((t, t + d * spf, lab))
        t += d * spf
    return out


def write_textgrid(path: str, durations: Sequence[int],
                   labels: Sequence[str], hop_length: int,
                   sample_rate: int, tier_name: str = "tokens"):
    """Write a single-tier Praat TextGrid (long format)."""
    ivs = durations_to_intervals(durations, labels, hop_length, sample_rate)
    x_max = ivs[-1][1] if ivs else 0.0
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {x_max:.6f}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        f'        name = "{tier_name}"',
        "        xmin = 0",
        f"        xmax = {x_max:.6f}",
        f"        intervals: size = {len(ivs)}",
    ]
    for i, (a, b, lab) in enumerate(ivs, 1):
        esc = lab.replace('"', '""')
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {a:.6f}",
            f"            xmax = {b:.6f}",
            f'            text = "{esc}"',
        ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
