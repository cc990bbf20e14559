"""``python -m modelx_tpu_torch.analysis`` — the CI lint gate.

Exit codes: 0 clean (or baseline-suppressed), 1 new findings, 2 bad
usage / malformed baseline.
"""

import sys

from modelx_tpu_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main())
