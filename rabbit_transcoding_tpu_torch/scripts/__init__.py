"""The port's twins of the repo's measurement scripts (``scripts/``): the
CTC rate ladders, the device scaling, the endurance drift check, the RBV RD
study and the shell loops around the apps.  Each runs on the card unless
the caller asks for the CPU (``--device cpu``; ``DEVICE=cpu`` for the shell
loops), and imports nothing of JAX or of the JAX package."""
