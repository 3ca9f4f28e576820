"""Transformer classifier over the 8x8 UCI digits — self-contained sample.

Treats each 8x8 digit as a sequence of 8 rows (T=8, E=8 features per
row) through a complete pre-LN transformer block — layer_norm ->
residual self_attention -> layer_norm -> residual ffn — then a dense
stack with a softmax head. The whole stack fuses into the pipelined
fused tick (attention/layer-norm/ffn per-leaf update policies), and
the trained model can be exported to the native C++ runtime, which
executes the same attention/ffn math.

Run: ``python -m veles_tpu_torch
veles_tpu_torch/samples/transformer_digits.py [--device cpu]``
Optional: ``root.transformer.heads``, ``root.transformer.epochs``,
``root.transformer.export`` (a .tar path to package the model after
training).

The port's copy of ``samples/transformer_digits.py``; it reads the
committed digits (``parity.digits_dataset``, the canonical permutation).
"""

import numpy

from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.parity import digits_dataset

root.transformer.update({
    "heads": 4,
    "epochs": 40,          # reaches ~3% validation error on digits
    "learning_rate": 0.1,
    "export": None,
})


def run(load, main):
    X, y = digits_dataset(flat=True)
    X = (X.reshape(-1, 8, 8) / 16.0).astype(numpy.float32)  # T=8, E=8
    cfg = root.transformer
    wf, _ = load(
        StandardWorkflow,
        name="TransformerDigits",
        layers=[
            {"type": "layer_norm"},
            {"type": "self_attention", "heads": cfg.heads,
             "residual": True},
            {"type": "layer_norm"},
            {"type": "ffn"},
            {"type": "all2all_tanh", "output_sample_shape": (32,)},
            {"type": "softmax", "output_sample_shape": (10,)},
        ],
        loader_kwargs=dict(data=X, labels=y,
                           class_lengths=[0, 297, 1500],
                           minibatch_size=100),
        learning_rate=cfg.learning_rate,
        decision_kwargs=dict(max_epochs=cfg.epochs))
    main()
    if cfg.get("export"):
        from veles_tpu_torch.export import package_export
        # root.sample.export_precision = 16 halves the package size
        # (f16 weights; the native runtime widens back to f32)
        package_export(wf, cfg.export,
                       precision=cfg.get("export_precision", 32))
        print("exported to", cfg.export)
