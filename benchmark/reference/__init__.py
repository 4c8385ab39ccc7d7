"""Plain PyTorch reference of what the benchmark's cells compute.

Imports nothing of the program under test: the detector, the poses, the
CT phantom, the Siddon and Joseph line integrals, the NCC and Adam are
worked out here again from the inputs the benchmark makes. It runs on any
device and dtype; the benchmark runs it in float64 on the card after the
measured window.
"""
