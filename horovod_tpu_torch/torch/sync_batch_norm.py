"""Cross-rank synchronized BatchNorm for the PyTorch frontend
(counterpart of ``horovod_tpu/torch/sync_batch_norm.py``, reference
``horovod/torch/sync_batch_norm.py``): batch statistics are computed over the
GLOBAL batch — local sums and counts are allreduced/allgathered — so small
per-rank batches still normalize correctly. Forward and backward each perform
one fused allreduce; the backward recurrence follows the standard batch-norm
gradient with global reductions (reference ``sync_batch_norm.py:130-194``)."""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch import basics
from horovod_tpu_torch.torch import mpi_ops


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm*d`` that synchronizes statistics
    across ranks during training (reference ``torch/sync_batch_norm.py:30-86``).
    Evaluation mode uses running statistics, exactly like plain BatchNorm."""

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)"
            )

    def forward(self, input):
        if not (self.training and basics.size() > 1):
            return super().forward(input)
        self._check_input_dim(input)
        if self.momentum is None:  # cumulative moving average
            exponential_average_factor = 0.0
        else:
            exponential_average_factor = self.momentum
        if self.training and self.track_running_stats:
            self.num_batches_tracked += 1
            if self.momentum is None:
                exponential_average_factor = 1.0 / float(
                    self.num_batches_tracked
                )
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, exponential_average_factor,
        )


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum):
        c = input.shape[1]
        x = input.transpose(0, 1).reshape(c, -1)  # [C, N*spatial]
        local_count = x.shape[1]

        # Two-pass statistics: allreduce [sum, count] -> global mean, then
        # allreduce the CENTERED sum of squares. Centering first keeps fp32
        # safe (no E[x^2]-mean^2 cancellation) on the fp32 wire.
        stats = torch.empty(c + 1, dtype=torch.float32, device=input.device)
        stats[:c] = x.sum(dim=1).float()
        stats[c] = float(local_count)
        stats = mpi_ops.allreduce(stats, op=mpi_ops.Sum)
        global_count = stats[c].item()
        mean = (stats[:c] / global_count).to(input.dtype)
        ssd = ((x - mean.unsqueeze(1).to(x.dtype)) ** 2).sum(dim=1).float()
        ssd = mpi_ops.allreduce(ssd, op=mpi_ops.Sum)
        var = (ssd / global_count).to(input.dtype)

        if running_mean is not None:
            with torch.no_grad():
                # unbiased var for running stats, as torch BatchNorm does
                unbiased = var * (global_count / max(global_count - 1, 1))
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)

        invstd = torch.rsqrt(var + eps)
        shape = [1, c] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape)) * invstd.view(shape)
        out = xhat
        if weight is not None:
            out = out * weight.view(shape)
        if bias is not None:
            out = out + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.global_count = global_count
        return out

    @staticmethod
    def backward(ctx, grad_output):
        xhat, weight, invstd = ctx.saved_tensors
        c = grad_output.shape[1]
        shape = [1, c] + [1] * (grad_output.dim() - 2)
        reduce_dims = [d for d in range(grad_output.dim()) if d != 1]

        # local per-channel reductions, then one fused cross-rank allreduce
        local = torch.empty(c, 2, dtype=torch.float32,
                            device=grad_output.device)
        local[:, 0] = grad_output.sum(dim=reduce_dims).float()
        local[:, 1] = (grad_output * xhat).sum(dim=reduce_dims).float()
        tot = mpi_ops.allreduce(local, op=mpi_ops.Sum)
        sum_dy = tot[:, 0].to(grad_output.dtype)
        sum_dy_xhat = tot[:, 1].to(grad_output.dtype)
        # weight/bias grads stay LOCAL sums — DistributedOptimizer averages
        # them with every other parameter gradient afterwards (reference
        # torch/sync_batch_norm.py backward returns the local reduce)
        local_sum_dy = local[:, 0].to(grad_output.dtype)
        local_sum_dy_xhat = local[:, 1].to(grad_output.dtype)
        n = ctx.global_count

        gamma = (
            weight if weight is not None else torch.ones_like(sum_dy)
        )
        grad_input = (
            gamma.view(shape) * invstd.view(shape) * (
                grad_output
                - (sum_dy / n).view(shape)
                - xhat * (sum_dy_xhat / n).view(shape)
            )
        )
        grad_weight = local_sum_dy_xhat if weight is not None else None
        grad_bias = local_sum_dy if weight is not None else None
        return grad_input, grad_weight, grad_bias, None, None, None, None
