"""Launchers of the port: the trainer (``python -m
repro_torch.launch.train``) and the cell harness: ``steps`` builds one
(architecture × input shape × mesh) step, ``roofline`` counts its cost
and ``dryrun`` / ``inspect_cell`` report it (``python -m
repro_torch.launch.dryrun``)."""
