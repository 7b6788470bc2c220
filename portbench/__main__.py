import sys
import time

# the set-up clock starts before torch is imported
T0 = time.monotonic()

from portbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
