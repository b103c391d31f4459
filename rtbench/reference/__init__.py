"""The benchmark's plain reference renderer (see render.py)."""
