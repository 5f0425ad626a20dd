"""The yardstick's arithmetic: the chip's published peaks and the operations
and bytes of the work a served forward needs.  PyTorch-free: it reads
sizes and counts only."""
