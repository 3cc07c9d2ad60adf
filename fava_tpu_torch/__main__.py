"""``python -m fava_tpu_torch``: run the analysis pipeline in the current
directory (reads pipeline_settings.json, resumes from fava.checkpoint),
on the card unless ``--device cpu`` is given. Counterpart of
fava_tpu/__main__.py."""

import argparse
import logging
import sys

from fava_tpu_torch.pipeline import main

LOGGER = logging.getLogger(__name__)


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m fava_tpu_torch",
        description="Run the four-stage FAVA pipeline in the current directory.",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device to compute on (default: cuda; a CUDA request without CUDA raises)",
    )
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args(sys.argv[1:])
    try:
        sys.exit(main(device=args.device))
    except Exception as exc:
        LOGGER.exception("", exc_info=exc)
        sys.exit(1)
