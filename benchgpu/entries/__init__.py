"""The program's entries that a window drives, one module each, named by a
configuration's `entry` (see benchgpu/harness.py for what a module holds)."""
