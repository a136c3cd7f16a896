"""``python -m horovod_tpu_torch.run`` == ``hvdrun_torch`` (reference
``bin/horovodrun``)."""

from horovod_tpu_torch.run.runner import main

if __name__ == "__main__":
    main()
