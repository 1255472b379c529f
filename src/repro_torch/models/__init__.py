"""The port's LM stack (``repro.models``): ``config``, ``layers``, the dense
``transformer`` and the family-dispatched ``api``."""
