"""Read models of the mixes, one module each (see benchgpu/traffic.py)."""
