"""Arithmetic-coding parameter set.

All codec numerology is derived from three integers ``(symbol_bits,
freq_bits, code_bits)`` exactly as the reference ``Parameters`` struct does
(``/root/reference/src/model/mod.rs:33-81``), including the validation
invariant (``model/mod.rs:64``)::

    symbol >= 1  and  freq >= symbol + 2  and  code >= freq + 2
    and  code + freq <= 64

The derived fields match field-for-field:

==================  =========================================  ===============
field               definition                                 reference line
==================  =========================================  ===============
symbol_eof          1 << symbol_bits                           model/mod.rs:71
symbol_count        (1 << symbol_bits) + 1                     model/mod.rs:72
freq_max            (1 << freq_bits) - 1                       model/mod.rs:74
code_min            0                                          model/mod.rs:77
code_one_fourth     1 << (code_bits - 2)                       model/mod.rs:78
code_half           2 << (code_bits - 2)                       model/mod.rs:79
code_three_fourths  3 << (code_bits - 2)                       model/mod.rs:80
code_max            (1 << code_bits) - 1                       model/mod.rs:81
==================  =========================================  ===============

Addition: :attr:`Parameters.fits_u32` reports whether every intermediate
product of the coder fits in 32 bits (``code + freq <= 32``), so the XLA
coders can run in uint32 instead of int64.
"""

from __future__ import annotations

import dataclasses

from .errors import InvalidInputError

# Default production configuration, matching the reference CLI's hardcoded
# AdaptiveTreeModel::new(Parameters::new(8, 30, 32)) (main.rs:108).
DEFAULT_SYMBOL_BITS = 8
DEFAULT_FREQ_BITS = 30
DEFAULT_CODE_BITS = 32

# 32-bit configuration: code_bits + freq_bits <= 32 keeps every
# product/division of the coder in uint32.
U32_SYMBOL_BITS = 8
U32_FREQ_BITS = 15
U32_CODE_BITS = 17

# Wide production configuration: products up to 2**42, 32x the frequency
# resolution of the 32-bit config (big warm-start priors + large adaptation
# increments without freezing).
WIDE_SYMBOL_BITS = 8
WIDE_FREQ_BITS = 20
WIDE_CODE_BITS = 22


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Validated arithmetic-coder parameters (reference model/mod.rs:33-81)."""

    symbol_bits: int
    freq_bits: int
    code_bits: int

    # Derived fields (filled by __post_init__).
    symbol_eof: int = dataclasses.field(init=False)
    symbol_count: int = dataclasses.field(init=False)
    freq_max: int = dataclasses.field(init=False)
    code_min: int = dataclasses.field(init=False)
    code_one_fourth: int = dataclasses.field(init=False)
    code_half: int = dataclasses.field(init=False)
    code_three_fourths: int = dataclasses.field(init=False)
    code_max: int = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        s, f, c = self.symbol_bits, self.freq_bits, self.code_bits
        # Exact reference validation expression (model/mod.rs:64).
        if s < 1 or f < s + 2 or c < f + 2 or 64 < c + f:
            raise InvalidInputError()
        object.__setattr__(self, "symbol_eof", 1 << s)
        object.__setattr__(self, "symbol_count", (1 << s) + 1)
        object.__setattr__(self, "freq_max", (1 << f) - 1)
        object.__setattr__(self, "code_min", 0)
        object.__setattr__(self, "code_one_fourth", 1 << (c - 2))
        object.__setattr__(self, "code_half", 2 << (c - 2))
        object.__setattr__(self, "code_three_fourths", 3 << (c - 2))
        object.__setattr__(self, "code_max", (1 << c) - 1)

    @property
    def fits_u32(self) -> bool:
        """True when all coder intermediates fit in uint32.

        The widest products are ``range * high`` on encode
        (codec.rs:59) and ``(pending - low + 1) * count - 1`` on decode
        (codec.rs:131), both bounded by ``2**code_bits * (2**freq_bits - 1)``
        which is ``< 2**32`` iff ``code_bits + freq_bits <= 32``.
        """
        return self.code_bits + self.freq_bits <= 32

    @classmethod
    def default(cls) -> "Parameters":
        """Reference CLI production config ``(8, 30, 32)`` (main.rs:108)."""
        return cls(DEFAULT_SYMBOL_BITS, DEFAULT_FREQ_BITS, DEFAULT_CODE_BITS)

    @classmethod
    def tpu32(cls) -> "Parameters":
        """32-bit config ``(8, 15, 17)``."""
        return cls(U32_SYMBOL_BITS, U32_FREQ_BITS, U32_CODE_BITS)

    @classmethod
    def tpu_wide(cls) -> "Parameters":
        """Wide production config ``(8, 20, 22)``."""
        return cls(WIDE_SYMBOL_BITS, WIDE_FREQ_BITS, WIDE_CODE_BITS)
