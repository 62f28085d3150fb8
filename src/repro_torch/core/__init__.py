"""RoboECC core — the paper's contribution, in the port.

The numpy-only modules of ``src/repro/core/`` carried as the port's own
copies (same code, held equal to the reference), and the LSTM predictor
rewritten in PyTorch:

* structure.py    — Eq. 1 structure model (flattened layer graphs)
* graph.py        — the port's graph: structure's, and a VLA over a
                    sparse-expert trunk costed layer by layer as MoE
* hardware.py     — Eq. 2 hardware roofline model (Table I + TPU v5e)
* segmentation.py — Alg. 1 optimal split search, the codec axis and the
                    multi-cut (S1, S2) placement search
* placement.py    — K-segment ``PlacementPlan``
* codec.py        — split-boundary transport codecs (wire bytes, priced
                    encode/decode compute)
* predictor.py    — LSTM bandwidth predictor in PyTorch (Eq. 3 check)
* pool.py         — parameter-sharing pool
* adjustment.py   — ΔNB / T_high / T_low fine-grained adjustment
* network.py      — bandwidth trace simulator
* scene.py        — scene-dynamics trace simulator (per-step token
                    change fractions for the temporal-delta codec)
* telemetry.py    — flight recorder: spans, streaming metrics, drift
                    audit (standard library only)
* pipeline.py     — streamed chunk-transport makespan model
* controller.py   — end-to-end RoboECC controller
"""
from .adjustment import (AdjustmentDecision, PlacementDecision, Thresholds,
                         adjust, adjust_placement, calibrate_thresholds)
from .codec import (CODECS, Codec, DeltaCodec, get_codec, make_codecs,
                    make_delta_codec, resolve_codecs, transport_s)
from .controller import RoboECC, TickResult
from .hardware import (A100, DEVICES, ORIN, THOR, TPU_V5E, DeviceSpec,
                       RooflineTerms, fit_eta, layer_latency, roofline,
                       stack_latency)
from .network import NetworkSim, TraceConfig, generate_trace
from .scene import (SCENES, SceneConfig, generate_scene_matrix,
                    generate_scene_trace, scene_config)
from .pipeline import (DEFAULT_CHUNK_GRID, chunk_sizes, stream_applies,
                       stream_bubble_fraction, stream_makespan,
                       stream_makespan_scalar)
from .placement import PlacementPlan
from .pool import Pool, build_pool, pool_transfer_profile
from .predictor import (Predictor, PredictorConfig, check_granularity,
                        init_lstm, lstm_forward, train_predictor)
from .segmentation import (GraphArrays, MulticutResult, PlacementEval,
                           SegmentationResult, VecSearchResult,
                           codec_applies, cut_bytes, downlink_bytes,
                           evaluate_placement, evaluate_split,
                           exhaustive_best, fixed_split, graph_arrays,
                           net_time, queue_delay_s, search, search_joint,
                           search_multicut,
                           search_multicut_scalar, search_streamed,
                           search_streamed_scalar, search_vec,
                           sweep_multicut, sweep_search)
from .graph import build_graph
from .structure import LayerCost, Workload, total_flops, total_weight_bytes

__all__ = [
    "AdjustmentDecision", "PlacementDecision", "Thresholds", "adjust",
    "adjust_placement", "calibrate_thresholds",
    "CODECS", "Codec", "DeltaCodec", "get_codec", "make_codecs",
    "make_delta_codec", "resolve_codecs", "transport_s",
    "RoboECC", "TickResult",
    "A100", "DEVICES", "ORIN", "THOR", "TPU_V5E", "DeviceSpec",
    "RooflineTerms", "fit_eta", "layer_latency", "roofline", "stack_latency",
    "NetworkSim", "TraceConfig", "generate_trace",
    "SCENES", "SceneConfig", "generate_scene_matrix", "generate_scene_trace",
    "scene_config",
    "DEFAULT_CHUNK_GRID", "chunk_sizes", "stream_applies",
    "stream_bubble_fraction", "stream_makespan", "stream_makespan_scalar",
    "PlacementPlan",
    "Pool", "build_pool", "pool_transfer_profile",
    "Predictor", "PredictorConfig", "check_granularity", "init_lstm",
    "lstm_forward", "train_predictor",
    "GraphArrays", "MulticutResult", "PlacementEval", "SegmentationResult",
    "VecSearchResult", "codec_applies", "cut_bytes", "downlink_bytes",
    "evaluate_placement", "evaluate_split", "exhaustive_best", "fixed_split",
    "graph_arrays", "net_time", "queue_delay_s", "search", "search_joint",
    "search_multicut",
    "search_multicut_scalar", "search_streamed", "search_streamed_scalar",
    "search_vec", "sweep_multicut", "sweep_search",
    "LayerCost", "Workload", "build_graph", "total_flops",
    "total_weight_bytes",
]
