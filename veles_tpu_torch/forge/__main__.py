import sys

from .client import main

sys.exit(main())
