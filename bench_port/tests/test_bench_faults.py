"""The check catches a broken timed path: the rest of a run is driven on
the CPU at a tiny size with the port broken underneath, and ``correct``
comes out false; the same run unbroken comes out true."""
import pytest

from bench_port.tests._tiny import run_cpu, tiny_cell


def test_sound_match_run_is_correct():
    assert run_cpu(tiny_cell("outdoor_ds.match_b4")).correct


def test_sound_train_run_is_correct():
    assert run_cpu(tiny_cell("outdoor_ds.train_b4")).correct


def _shift_fine(monkeypatch):
    import loftr_tpu_torch.models.matcher as matcher
    real = matcher.fine_kpts

    def moved(*a, **k):
        k0, k1 = real(*a, **k)
        return k0, k1 + 8.0
    monkeypatch.setattr(matcher, "fine_kpts", moved)


def _shift_coarse(monkeypatch):
    import loftr_tpu_torch.models.matcher as matcher
    real = matcher.M.topk_matches

    def moved(cand, k):
        m = real(cand, k)
        return m.__class__(i_ids=m.i_ids, j_ids=m.j_ids + 1, mconf=m.mconf,
                           mask=m.mask, gt_mask=m.gt_mask)
    monkeypatch.setattr(matcher.M, "topk_matches", moved)


def _nan_fine(monkeypatch):
    import loftr_tpu_torch.models.matcher as matcher
    real = matcher.fine_kpts

    def nan(*a, **k):
        k0, k1 = real(*a, **k)
        return k0, k1 * float("nan")
    monkeypatch.setattr(matcher, "fine_kpts", nan)


@pytest.mark.parametrize("fault", [_shift_fine, _nan_fine, _shift_coarse],
                         ids=["fine_keypoint_altered", "fine_keypoint_nan",
                              "coarse_match_altered"])
def test_altered_answer_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cpu(tiny_cell("outdoor_ds.match_b4")).correct


def _state_unchanged(monkeypatch):
    from loftr_tpu_torch.train.trainer import Trainer

    def no_update(self, state, grads):
        state.step += 1
        return 0.0
    monkeypatch.setattr(Trainer, "apply_gradients", no_update)


def _half_batch(monkeypatch):
    from loftr_tpu_torch.structs import MatchInput
    from loftr_tpu_torch.train.trainer import Trainer
    real = Trainer.train_step

    def half(self, state, batch, noise=None):
        n = batch.image0.shape[0] // 2
        cut = MatchInput(**{k: None if v is None else v[:n]
                            for k, v in vars(batch).items()})
        return real(self, state, cut, noise)
    monkeypatch.setattr(Trainer, "train_step", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cpu(tiny_cell("outdoor_ds.train_b4"))
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]
