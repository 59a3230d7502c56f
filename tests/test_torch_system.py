"""End-to-end system test on the port: the paper's pipeline on a tiny model
(the twin of ``tests/test_system.py``, run eagerly on the CPU).

base pretrain -> SFT fine-tune -> delta -> DeltaDQ compress -> serve
through ``Engine.generate`` -> the compressed tenant keeps the
fine-tuned capability (sorting accuracy) while the raw base does not.
The thresholds are the reference test's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ArchConfig  # noqa: E402
from repro_torch.core import DeltaDQSpec, compress  # noqa: E402
from repro_torch.data import FormatOnlyTask, PretrainMixture, SortTask  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

TINY = ArchConfig(
    name="tiny-sys", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, head_dim=16, d_ff=128, vocab=64, act="silu", tie_embeddings=True,
)


def _train(cfg, params, data, steps, lr=5e-3):
    opt = adamw.init(params)
    step = make_train_step(cfg, AdamWConfig(lr=lr, weight_decay=0.0))
    for i in range(steps):
        params, opt, m = step(params, opt, data.batch_at(i), i)
    return params, float(m["loss"])


def _task_accuracy(engine: Engine, tenant, task: SortTask, n_batches=2) -> float:
    """Exact-match digit accuracy of generated completions."""
    correct = total = 0
    for s in range(n_batches):
        prompts, targets = task.prompts_at(100 + s)
        gen = engine.generate(tenant, prompts, max_new_tokens=task.n_digits)
        correct += (gen[:, :task.n_digits] == targets).sum()
        total += targets.size
    return correct / total


@pytest.fixture(scope="module")
def pipeline():
    """Paper regime: the base knows the task FORMAT (random answers), SFT
    adds a small decisive delta."""
    base = lm.init_params(TINY, 0, device="cpu")
    pre = PretrainMixture(vocab=TINY.vocab, seq_len=24, batch=16, seed=0)
    base, _ = _train(TINY, base, pre, 20)
    fmt = FormatOnlyTask(vocab=TINY.vocab, seq_len=24, batch=16, n_digits=4, seed=2)
    base, _ = _train(TINY, base, fmt, 120, lr=3e-3)
    task = SortTask(vocab=TINY.vocab, seq_len=24, batch=16, n_digits=4, seed=1)
    ft, ft_loss = _train(TINY, base, task, 180, lr=1.5e-3)
    return base, ft, task, ft_loss


def test_sft_learned_task(pipeline):
    base, ft, task, ft_loss = pipeline
    assert ft_loss < 0.5  # fine-tune actually learned to sort
    # training hands back plain tensors: the engine runs them under inference mode
    for p in (base["attn"]["wq"], ft["embed"]["tok"]):
        assert not p.requires_grad and p.grad_fn is None


def test_full_deltadq_pipeline(pipeline):
    base, ft, task, _ = pipeline
    eng = Engine(TINY, base, max_seq=32)

    results = {}
    for name, spec in {
        "a2": DeltaDQSpec(alpha=2.0, k_bits=None, h_g=16),
        "a4_k8": DeltaDQSpec(alpha=4.0, k_bits=8, m=1, h_g=16),
    }.items():
        deltas, report = compress(base, ft, spec)
        eng.register_tenant(name, deltas, report)
        results[name] = _task_accuracy(eng, name, task)

    acc_base = _task_accuracy(eng, None, task)
    eng_ft = Engine(TINY, ft, max_seq=32)
    acc_ft = _task_accuracy(eng_ft, None, task)

    # fine-tuned model masters the task; base does not
    assert acc_ft > 0.85, acc_ft
    assert acc_base < 0.6, acc_base
    # compressed tenants retain most of the capability
    for name, acc in results.items():
        assert acc > 0.8 * acc_ft, (name, acc, acc_ft)

    rep = eng.memory_report()
    assert rep["delta_bytes_total"] < 2 * rep["base_bytes"]
