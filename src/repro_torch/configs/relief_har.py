"""The paper's own task configurations: PAMAP2 / MHEALTH multimodal HAR
with Backbone 1 (CNN, full-parameter) and Backbone 2 (frozen transformer +
LoRA rho=8), verbatim from the reference's ``configs/relief_har.py``."""
from repro_torch.data.har import mm_config_for

# paper-scale configs (Sec. VI-A3)
PAMAP2_B1 = mm_config_for("pamap2", backbone="cnn", d_feat=32,
                          d_fused=128, cnn_ch=(32, 64))
PAMAP2_B2 = mm_config_for("pamap2", backbone="transformer", d_feat=32,
                          d_fused=128, enc_layers=4, enc_d=128, enc_ff=256)
MHEALTH_B1 = mm_config_for("mhealth", backbone="cnn", d_feat=32,
                           d_fused=128, cnn_ch=(32, 64))
MHEALTH_B2 = mm_config_for("mhealth", backbone="transformer", d_feat=32,
                           d_fused=128, enc_layers=4, enc_d=128, enc_ff=256)

# reduced configs for CPU runs and tests
PAMAP2_B1_SMALL = mm_config_for("pamap2", backbone="cnn", d_feat=16,
                                d_fused=64, cnn_ch=(16, 32))
PAMAP2_B2_SMALL = mm_config_for("pamap2", backbone="transformer", d_feat=16,
                                d_fused=64, enc_layers=2, enc_d=32, enc_ff=64)
MHEALTH_B1_SMALL = mm_config_for("mhealth", backbone="cnn", d_feat=16,
                                 d_fused=64, cnn_ch=(16, 32))
MHEALTH_B2_SMALL = mm_config_for("mhealth", backbone="transformer",
                                 d_feat=16, d_fused=64, enc_layers=2,
                                 enc_d=32, enc_ff=64)

CONFIGS = {
    ("pamap2", "b1"): PAMAP2_B1, ("pamap2", "b2"): PAMAP2_B2,
    ("mhealth", "b1"): MHEALTH_B1, ("mhealth", "b2"): MHEALTH_B2,
    ("pamap2", "b1", "small"): PAMAP2_B1_SMALL,
    ("pamap2", "b2", "small"): PAMAP2_B2_SMALL,
    ("mhealth", "b1", "small"): MHEALTH_B1_SMALL,
    ("mhealth", "b2", "small"): MHEALTH_B2_SMALL,
}
