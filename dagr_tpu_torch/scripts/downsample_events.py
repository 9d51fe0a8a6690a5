"""Downsample an events.h5 stream 2x spatially (the events_2x.h5 that the
DSEC reader takes).

The port's counterpart of dagr_tpu's ``scripts/downsample_events.py``
(the reference scripts/downsample_events.py:127-163), on
``data.downsample.downsample_file``; host work only (numpy and h5py)::

    python -m dagr_tpu_torch.scripts.downsample_events \\
        --input_path events.h5 --output_path events_2x.h5
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from dagr_tpu_torch.data.downsample import downsample_file


def main(argv: Optional[Sequence[str]] = None) -> Path:
    p = argparse.ArgumentParser("Downsample events")
    p.add_argument("--input_path", type=Path, required=True)
    p.add_argument("--output_path", type=Path, required=True)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--output_height", type=int, default=240)
    p.add_argument("--output_width", type=int, default=320)
    a = p.parse_args(argv)
    downsample_file(a.input_path, a.output_path,
                    a.input_height, a.input_width,
                    a.output_height, a.output_width)
    print(f"wrote {a.output_path}")
    return a.output_path


if __name__ == "__main__":
    main(sys.argv[1:])
