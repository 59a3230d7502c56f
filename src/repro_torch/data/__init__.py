from repro_torch.data.pipeline import (
    EOS,
    PAD,
    SEP,
    FormatOnlyTask,
    MemmapTokens,
    PretrainMixture,
    SortTask,
    SyntheticLM,
)

__all__ = ["EOS", "PAD", "SEP", "FormatOnlyTask", "MemmapTokens", "PretrainMixture",
           "SortTask", "SyntheticLM"]
