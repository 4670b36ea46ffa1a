"""The port's optimizers through a checkpoint: every ``--opt`` base name,
two Lookahead forms and ``--bf16_moments``, on test_torch_optim.py's small
``ft_vit`` and gradient sequence, checkpointed mid-run through the CLIs'
.pth (utils.checkpoint) and resumed by a new model and optimizer, must
continue bit-identically. One run per optimizer gives the uninterrupted
steps and the checkpoint. Torch runs on one thread here: the steps are
small, and beside other test processes a thread pool only waits."""
import pytest
import torch

from test_torch_optim import NAMES, STEPS, _grads, _lr, _port, _port_step, _variables

SAVE_AFTER = 3      # steps before the checkpoint


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES + ["lookahead_adamp", "lookahead_sgd", "bf16_adamw"])
def test_checkpoint_round_trip_continues_bit_identically(rng, name, tmp_path):
    """7 steps in one run, which writes a checkpoint after its third; a new
    model and optimizer from the checkpoint take the last 4 steps: the
    weights are bit-identical to the run's."""
    from mem_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    dt = torch.bfloat16 if name.startswith("bf16_") else None
    opt_name = name.removeprefix("bf16_")
    variables = _variables(rng)
    lr = _lr(opt_name)
    grads = [_grads(rng, variables, t) for t in range(STEPS)]
    whole, opt = _port(variables, opt_name, 0.75, dt)
    for t in range(STEPS):
        _port_step(whole, opt, grads[t], t, lr)
        if t == SAVE_AFTER - 1:
            path = save_checkpoint(str(tmp_path), t, {"model": whole.state_dict(),
                                                      "optimizer": opt.state_dict(), "epoch": t})
    payload = load_checkpoint(path)
    resumed, opt = _port(variables, opt_name, 0.75, dt)
    resumed.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    for t in range(SAVE_AFTER, STEPS):
        _port_step(resumed, opt, grads[t], t, lr)
    want = dict(whole.named_parameters())
    for k, p in resumed.named_parameters():
        assert torch.equal(p, want[k]), k
    if dt is not None:
        assert all(st["exp_avg"].dtype == dt for st in opt.state.values())
