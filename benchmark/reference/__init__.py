"""The benchmark's plain reference of the D4PG learner.

A frozen statement of the math the timed path computes, in plain PyTorch
(float32, TF32 off unless a caller asks for the lower precision): the
MLP and pixel actor and critic (``nets.py``), the categorical Bellman
projection and its cross-entropy, Adam, the soft target update, the DrQ
shift and the gradient average over data-parallel ranks
(``learner.py``), and the PER sum tree with its stratified descent, IS
weights and priority write-back (``per.py``).

It imports nothing of the program and takes nothing the program made:
the harness hands it the inputs it also handed the program (initial
weights, ring rows, the random draws), and it works out the rest again.
"""
