"""The plain reference that decides ``correct``.

Plain PyTorch and numpy, run once the window has closed.  It imports
neither ``jax`` nor ``spectavi_tpu`` nor anything of the port
(``spectavi_tpu_torch``): the parts the port also has are frozen copies
of its plain code (:mod:`.ops`, :mod:`.sift`, :mod:`.geometry`,
:mod:`.bundle_adjust`, :mod:`.ransac`, :mod:`.tracks`), and :mod:`.judge` holds the numbers that are
compared, each with the reference's own arithmetic.  The inputs are the
benchmark's (:mod:`sfmbench.scene`); what the program derived from them
is worked out again here, and the program's outputs are read only to be
judged.
"""
