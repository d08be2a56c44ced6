"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``);
tests marked ``gpu`` need a CUDA device and skip without one."""
