"""``python -m cubicsdr_tpu_torch``: the port's command-line shell
(``app/cli.py``)."""

import sys

from cubicsdr_tpu_torch.app.cli import main

if __name__ == "__main__":
    sys.exit(main())
