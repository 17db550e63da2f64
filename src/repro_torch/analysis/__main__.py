"""``python -m repro_torch.analysis`` — the port's disagglint CLI."""
import sys

from repro_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
