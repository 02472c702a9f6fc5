"""One module a model, named by a configuration's ``"model"`` key and
found by that name (``run.model``): ``portbench/models/<model>.py``.

A model module gives the harness everything that depends on the model,
and the harness names nothing of it:

- the program side: ``trainer_class()`` (the tartangan_torch trainer,
  imported when called, so that the rest loads nothing of the program),
  ``trainer_argv(cfg, traffic, data_path, out_dir, seed, device)`` (its
  flags), ``DRAWS`` ({name: batch axis or None} of every draw its step
  takes, the positional ones first, in the step's order) and
  ``programs_config(cfg)`` (the configuration's keys as the program
  builds them);
- the shapes: ``architecture(cfg)`` (what the reference and the counts
  read) and ``image_size(arch)`` (the side of the images it trains on);
- the reference side: ``reference``, a module of plain PyTorch that
  imports nothing of the program, with ``full_float32()``, ``fp8`` and
  ``Trainer(arch, hp, weights, device, quant=None, dtype=float32)``, whose
  ``step(batch_u8, draws, gp_weight)`` and ``g_grads(draws)`` take one
  step's draws by name and whose ``state()`` names what the check
  compares; ``make_weights(arch, hp, seed, device)`` ({"g", "d"} state
  dicts both sides load); ``draws(gen, b, arch, device)`` (one step's
  draws as the program makes them from its generator);
- the counts (``portbench/flops.py``'s ``Conv`` and ``Attention``), for a
  step at batch ``b`` with R1 or not: ``conv_ops(arch, b, r1)``,
  ``attention_ops(arch, b, r1)`` and ``kernel_launches(arch, b, r1)``.
"""
