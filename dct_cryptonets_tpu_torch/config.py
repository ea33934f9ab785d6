"""CLI configuration, the port's copy of ``dct_cryptonets_tpu.config``:
the same flags and defaults (flag-for-flag parity with the reference
argparse profiles, reference io_utils.py:13-90) and checkpoint directory
names, plus ``--device``.

``--device`` (default ``cuda``) names where the port runs; the CPU runs
only when asked for (``--device cpu``).
"""
import argparse


def parse_args(script: str, argv=None):
    parser = argparse.ArgumentParser(
        description=("DCT-CryptoNets-TPU "
                     f"({'Training' if script == 'train' else 'Homomorphic Evaluation'})"),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    g = parser.add_argument_group("Default arguments")
    g.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "ImageNet", "Imagenette",
                            "miniImagenet", "synthetic", "digits"])
    g.add_argument("--model", default="ResNet18qat",
                   choices=["ResNet20", "ResNet20qat", "ResNet18", "ResNet18qat"])
    g.add_argument("--num_classes", default=10, type=int)
    g.add_argument("--dataset_path", metavar="PATH")
    g.add_argument("--save_path", metavar="PATH", default="./runs")
    g.add_argument("--train_aug", action="store_true")
    g.add_argument("--dct_status", action="store_true")
    g.add_argument("--channels", default=64, type=int,
                   choices=[3, 6, 24, 48, 64, 192])
    g.add_argument("--filter_size", default=8, type=int)
    g.add_argument("--image_size", default=32, type=int)
    g.add_argument("--image_size_dct", default=56, type=int)
    g.add_argument("--dct_pattern", default="default",
                   choices=["default", "square", "triangle", "learned"])
    g.add_argument("--bit_width", default=4, type=int)
    g.add_argument("--dropout", default=None, type=float)
    g.add_argument("--verbose", default=True, type=bool)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs; 'cpu' only when asked for")
    g.add_argument("--mesh", default=None, type=str,
                   help="data-parallel mesh size, e.g. '8' (default: all devices)")
    g.add_argument("--profile_dir", default=None, metavar="PATH",
                   help="write a torch.profiler trace (TensorBoard/Perfetto) "
                        "of the whole run to this directory — the "
                        "framework's replacement for the reference's "
                        "wall-clock-only spans (SURVEY §5 tracing)")

    if script == "train":
        t = parser.add_argument_group("Training arguments")
        t.add_argument("--save_freq", default=5, type=int)
        t.add_argument("--start_epoch", default=0, type=int)
        t.add_argument("--stop_epoch", default=400, type=int)
        t.add_argument("--resume", default="", type=str, metavar="PATH")
        t.add_argument("--optimizer", default="adam",
                       choices=["adam", "adamw", "sgd"])
        t.add_argument("--lr", default=0.001, type=float)
        t.add_argument("--weight_decay", default=1e-5, type=float)
        t.add_argument("--momentum", default=0.9, type=float)
        t.add_argument("--grad_clip_value", default=None, type=float)
        t.add_argument("--grad_clip_norm", default=None, type=float)
        t.add_argument("--batch_size", default=16, type=int)
        t.add_argument("--test_batch_size", default=2, type=int)
        t.add_argument("--gamma", type=float, default=0.1)
        t.add_argument("--schedule", type=int, nargs="+", default=None)
        t.add_argument("--checkpoint_dir", default="", type=str, metavar="PATH")
        t.add_argument("--num_workers", default=4, type=int)
        t.add_argument("--synthetic_size", default=2048, type=int)
    elif script == "homomorphic_eval":
        h = parser.add_argument_group("Homomorphic evaluation arguments")
        h.add_argument("--checkpoint_path", type=str)
        h.add_argument("--calib_batch_size", default=64, type=int)
        h.add_argument("--test_batch_size", default=1, type=int)
        h.add_argument("--test_subset", default=1, type=int)
        h.add_argument("--fhe_mode", default="simulate",
                       choices=["simulate", "execute"])
        h.add_argument("--rounding_threshold_bits", default=6, type=int)
        h.add_argument("--rounding_method", default="exact",
                       choices=["exact", "approximate"],
                       help="rounded-TLU exactness (Concrete's Exactness "
                            "knob; 'exact' is its and our default, "
                            "'approximate' skips LSB clearing for speed)")
        h.add_argument("--n_bits", default=5, type=int)
        h.add_argument("--p_error", default=0.01, type=float)
        h.add_argument("--reliability_test", default=True)
        h.add_argument("--pbs_batch", default=4096, type=int)
        h.add_argument("--drop_limbs", default=0, type=int,
                       help="approximate-throughput mode: low BSK byte limbs "
                            "to skip in the external product")
        h.add_argument("--drop_policy", default="none",
                       choices=["none", "audit"],
                       help="'audit': per-TLU-layer throughput knobs (limb "
                            "drops, cross skip, truncated KSKs) chosen by "
                            "the circuit noise audit under the p_error "
                            "contract — Concrete's optimizer role; 'none': "
                            "bit-exact vs the simulator while ciphertext "
                            "noise stays below half an accumulator LSB")
        h.add_argument("--range_margin", default=1.0, type=float,
                       help="safety factor on calibrated accumulator "
                            "ranges; 1.0 (default) = Concrete-ML parity "
                            "(exact observed ranges), 2.0 spends one "
                            "extra bit per accumulator against phase "
                            "wrap on out-of-calibration data")
        h.add_argument("--slip_audit", action="store_true",
                       help="execute mode only: decrypt every TLU output "
                            "and compare against the clear simulator — "
                            "reports the REALIZED per-TLU slip count vs "
                            "the audited p_error (slipped values are "
                            "re-aligned so each TLU measures its own slip "
                            "rate); needs client keys, debug/validation "
                            "instrumentation")
        h.add_argument("--sweep_state", default=None, metavar="PATH",
                       help="JSONL checkpoint for long execute sweeps: "
                            "per-batch results persist here and a re-run "
                            "with the same config resumes instead of "
                            "restarting (~minutes/image encrypted)")
        h.add_argument("--dump_circuit", default=None, metavar="PATH",
                       help="write the compiled circuit listing + noise-"
                            "audit summary to PATH — the analog of the "
                            "reference's MLIR dump to mlir.txt "
                            "(homomorphic_eval.py:309-311)")
        h.add_argument("--residual_mode", default="fused",
                       choices=["fused", "requant"],
                       help="'fused' (default): requant-elided residual "
                            "adds — raw conv accumulators feed the add "
                            "through per-channel multipliers, eliding the "
                            "quant_out/quant_sc bootstraps (~30%% fewer "
                            "PBS, higher arithmetic fidelity); 'requant' "
                            "reproduces the reference graph's Brevitas "
                            "QuantIdentity requant TLUs literally")
    else:
        raise ValueError("Unknown script")
    return parser.parse_args(argv)


def checkpoint_dir_for(params) -> str:
    """Config-derived checkpoint directory naming (reference train.py:190-203)."""
    if params.checkpoint_dir.strip():
        return params.checkpoint_dir
    if params.dct_status:
        return (f"{params.save_path}/checkpoints/{params.dataset}/"
                f"{params.model}_dct/filter_{params.filter_size}"
                f"__pattern_{params.dct_pattern}"
                f"__input_{params.channels}_{params.image_size_dct}_{params.image_size_dct}"
                f"__bitwidth_{params.bit_width}")
    return (f"{params.save_path}/checkpoints/{params.dataset}/{params.model}/"
            f"input_{params.channels}_{params.image_size}_{params.image_size}"
            f"__bitwidth_{params.bit_width}")
