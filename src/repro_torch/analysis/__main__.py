"""``python -m repro_torch.analysis`` — run the port's repro-lint CLI."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
