import sys

from lz4bench.run import main

sys.exit(main())
