"""Plain references, one file each, named by a config's ``reference``.
They import nothing of ``samd_tpu_torch`` and take nothing the program
made: they draw the weights again from the seed (``harness.draws``) and
work out every derived form themselves."""
