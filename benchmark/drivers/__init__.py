"""One module per traffic ``kind``: it builds the program's objects for a
cell, drives the timed step, and follows the first steps or the sampled
answers with the plain reference. The harness finds it by the kind's name."""
