from .checksum import (ACCUMULATOR_DTYPES, LAUNCHES, QAChecksumAccumulator,
                       QAStats, device_checksum, device_checksum_plain,
                       initial_carry, qa_checksum, qa_checksum_batched,
                       qa_checksum_batched_plain, qa_checksum_chunk,
                       qa_checksum_chunk_plain, qa_stats, reset_launches)
from .ref import (device_checksum_ref, qa_checksum_ref,
                  qa_checksum_batched_ref)

__all__ = ["ACCUMULATOR_DTYPES", "LAUNCHES", "QAChecksumAccumulator",
           "QAStats", "device_checksum", "device_checksum_plain",
           "device_checksum_ref", "initial_carry", "qa_checksum", "qa_checksum_ref",
           "qa_checksum_batched", "qa_checksum_batched_plain",
           "qa_checksum_batched_ref", "qa_checksum_chunk",
           "qa_checksum_chunk_plain", "qa_stats", "reset_launches"]
