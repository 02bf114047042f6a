"""Model FLOPs of one D4PG grad step with MLP actor and critic.

Two FLOPs per multiply-add of each dense product, counted per sample and
times the batch, for the products a grad step requires, whatever
implements them (elementwise work, the softmax, the projection and Adam
are left out: they are far below a percent of it). With ``f_a`` and
``f_c`` one actor and one critic forward:

  - critic loss: the target actor and target critic forwards on s'
    (``f_a + f_c``), the critic forward on (s, a) and its backward: the
    weight gradients (``f_c``) and the input gradients of every layer
    whose input needs one (not ``fc1``'s state, not the action that
    joins ``fc2``);
  - policy loss: the actor forward (``f_a``), the stepped critic's
    forward on (s, pi(s)) (``f_c``), the critic's input gradients down
    to the action only (head, the hidden layers after ``fc2``, and
    ``fc2``'s action columns), then the actor's weight gradients
    (``f_a``) and its input gradients after ``fc1``.
"""

from __future__ import annotations


def mlp_per_sample(obs: int, act: int, hidden, atoms: int) -> int:
    h = list(hidden)
    actor = [(obs, h[0]), *zip(h[:-1], h[1:]), (h[-1], act)]
    critic = [(obs, h[0]), (h[0] + act, h[1]), *zip(h[1:-1], h[2:]),
              (h[-1], atoms)]
    f_a = sum(2 * i * o for i, o in actor)
    f_c = sum(2 * i * o for i, o in critic)
    # critic-loss input gradients: fc2's hidden columns, later layers
    crit_in = 2 * h[0] * h[1] + sum(2 * i * o for i, o in critic[2:])
    # policy loss through the critic: the head and the layers after fc2,
    # and fc2's action columns
    to_action = 2 * act * h[1] + sum(2 * i * o for i, o in critic[2:])
    actor_in = sum(2 * i * o for i, o in actor[1:])
    return 3 * f_a + 4 * f_c + crit_in + to_action + actor_in


def flops_per_step(cfg: dict, batch: int) -> int:
    return batch * mlp_per_sample(int(cfg["obs_dim"]), int(cfg["act_dim"]),
                                  cfg["hidden"], int(cfg["n_atoms"]))
