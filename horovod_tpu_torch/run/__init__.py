"""The launcher side of horovod_tpu_torch, as far as the port has it:
:mod:`~horovod_tpu_torch.run.rendezvous`'s in-memory KV core, the
elastic driver's membership plane. The launcher itself waits for
ROADMAP Queue A item 12."""
