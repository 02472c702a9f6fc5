"""FID/IS trainer component.

Counterpart of ``tartangan_tpu/train/components/metrics/fid.py``
(reference components/metrics/fid.py:10-55): the metrics closure is made
at train begin on the trainer's device; every ``--fid-freq`` steps
``--n-inception-imgs`` G samples go through it, and ``fid``,
``inception_score_mean`` and ``inception_score_std`` are appended to the
logs. The samples stay on the device (``Trainer.generate``): only the
softmax rows and the moment sums are read back, once.
"""
from __future__ import annotations

from ....utils.cli import type_or_none
from .base import FileBasedMetricsComponent


class FIDComponent(FileBasedMetricsComponent):
    """Calculate Frechet Inception Distance + Inception Score."""

    def on_train_begin(self, steps, logs):
        from ....eval.fid import prepare_inception_metrics
        print("Preparing inception metrics...")
        if self.trainer.args.n_inception_imgs <= 2048:
            print(f"WARNING: --n-inception-imgs "
                  f"{self.trainer.args.n_inception_imgs} <= 2048 makes the "
                  "pool covariance rank-deficient; FID will lean on the "
                  "eps-offset fallback")
        self.get_inception_metrics = prepare_inception_metrics(
            self.trainer.args.inception_moments,
            device=self.trainer.device,
            weights=self.trainer.args.inception_weights)

    def on_batch_end(self, steps, logs):
        if steps and self.every(self.trainer.args.fid_freq, steps):
            print("Calculating inception metrics...")
            is_mean, is_std, fid = self._calculate()
            logs["fid"].append(fid)
            logs["inception_score_mean"].append(is_mean)
            logs["inception_score_std"].append(is_std)

    def _calculate(self):
        is_mean, is_std, fid = self.get_inception_metrics(
            self.trainer.generate, self.trainer.args.n_inception_imgs,
            num_splits=5)
        print("Inception Score is %3.3f +/- %3.3f" % (is_mean, is_std))
        print("FID is %5.4f" % (fid,))
        return is_mean, is_std, fid

    @classmethod
    def add_args_to_parser(cls, parser):
        parser.add_argument("--inception-moments", type=type_or_none(str),
                            default=None,
                            help="Path to pre-calculated inception moments")
        parser.add_argument("--inception-weights", type=type_or_none(str),
                            default=None,
                            help="Ported Inception-weights npz (see "
                                 "tartangan_torch.eval.port_weights); falls "
                                 "back to $TARTANGAN_INCEPTION_WEIGHTS")
        parser.add_argument("--n-inception-imgs", default=1000, type=int)
        parser.add_argument("--fid-freq", default=10000, type=int,
                            help="Calculate test metrics every N batches")
