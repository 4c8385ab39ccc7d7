"""The benchmark's yardstick: window arithmetic, peaks, and what a kernel
launch must read, write and compute. Frozen here so that a change to the
program cannot move it."""
