"""``python -m iq_to_audio_torch``: the port's command line."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
