"""Parallel runtime (counterpart of :mod:`art_tpu.parallel`): the batch
queue, one worker per device, with decode, plan and encode on host
threads overlapping the device."""

from art_tpu_torch.parallel.queue import BatchQueue, process_batch  # noqa: F401
