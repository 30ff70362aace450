

def test_seq_lp_cap_hbm_envelope():
    # The large-m chronological LP-buffer ceiling (hl2_seq.seq_lp_cap):
    # small-m grows to the full year; m>336 keeps the memory cap
    # (~4096/Y total lanes -> 4096/Y^2 per year; see seq_lp_cap).
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        seq_lp_cap)
    assert seq_lp_cap(120, 8760, 16) == 8760           # RTS-96 class
    assert seq_lp_cap(792, 8760, 2) == 1024            # 2048 total: fits
    assert seq_lp_cap(792, 8760, 4) == 256             # 1024 total: fits
    assert seq_lp_cap(792, 8760, 1) == 4096
    assert seq_lp_cap(792, 8760, 8) == 128             # floor
