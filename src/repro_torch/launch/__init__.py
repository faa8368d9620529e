"""repro_torch.launch — entry points: serve (``launch.serve``) and train
(``launch.train``), and the step functions they drive (``launch.steps``)."""
