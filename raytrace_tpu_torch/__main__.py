"""``python -m raytrace_tpu_torch``: the command line of the port (the
reference executable's flags, utils/cli.py), rendering on the GPU."""

import sys

from .utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
