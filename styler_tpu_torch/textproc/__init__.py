from styler_tpu_torch.textproc.symbols import (  # noqa: F401
    PAD_ID,
    VOCAB_SIZE,
    symbol_to_id,
    symbols,
)
from styler_tpu_torch.textproc.sequence import (  # noqa: F401
    sequence_to_text,
    text_to_sequence,
)
from styler_tpu_torch.textproc.cleaners import english_cleaners  # noqa: F401
from styler_tpu_torch.textproc.g2p import G2p, to_phoneme_string  # noqa: F401
