#!/usr/bin/env python
"""Launcher for the cnn_sr CLI (the reference's ``bin/cnn.exe``):

    python cnn.py [train] [dry] [profile] -c cfg.json -i <in> [-o <out>] [-e N]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cnn_sr.cli import main
from cnn_sr.utils.compile_cache import configure_compile_cache

if __name__ == "__main__":
    configure_compile_cache()
    sys.exit(main())
