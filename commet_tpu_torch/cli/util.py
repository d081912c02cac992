"""CLI error contract: the reference tools print one-line errors to
stderr and exit(1) on bad inputs (e.g. "Error: Cannot open Fasta File
<f>", include/fasta_file.h:55-57; "Number of reads in <f> and boolean
vector size are not equal -> quit", fasta_file.h:108-111). The guarded
entry point reproduces that behavior instead of surfacing Python
tracebacks; ``main()`` functions stay raw for in-process callers/tests.
"""

from __future__ import annotations

import sys


def guarded(main_fn, argv=None) -> int:
    try:
        return main_fn(argv)
    except FileNotFoundError as exc:
        name = getattr(exc, "filename", None) or str(exc)
        print(f"Error: Cannot open file {name}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
