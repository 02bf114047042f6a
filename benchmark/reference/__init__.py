"""The benchmark's plain reference of the D4PG learner.

A frozen statement of the math the timed path computes, in plain PyTorch
(float32, TF32 off unless a caller asks for the lower precision): the
pieces the families' networks are built from, the MLP, the critic torso
and the pixel encoder (``nets.py``); the DrQ shift (``augment.py``); the
D4PG grad step with its categorical Bellman projection and
cross-entropy, the soft target update and the gradient average over
data-parallel ranks (``d4pg.py``), which each family's ``Learner``
completes with its networks (``families/<family>.py``); Adam and the
first grad steps of a fused chunk (``learner.py``); and the PER sum tree
with its stratified descent, IS weights and priority write-back
(``per.py``).

It imports nothing of the program and takes nothing the program made:
the harness hands it the inputs it also handed the program (initial
weights, ring rows, the random draws), and it works out the rest again.
"""
