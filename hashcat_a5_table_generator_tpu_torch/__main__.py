"""``python -m hashcat_a5_table_generator_tpu_torch`` — the a5gen CLI."""

import sys

from .cli import main

sys.exit(main())
