"""Dataset shapes of the synthetic stand-in corpora.

Only ``DATASET_SHAPES`` is ported so far; the scenario library
(``ScenarioSpec`` and its grid) is still to port.
"""

#: feature shapes + class counts of the synthetic stand-in corpora
#: (data/synthetic.py) — the shapes the adapters build models for
DATASET_SHAPES = {"iemocap": ({"audio": (32, 11), "text": (24, 100)}, 10),
                  "crema_d": ({"audio": (32, 11), "image": (32, 32, 3)}, 6)}
