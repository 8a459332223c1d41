"""Default configuration tree: every key of the JAX package's
``yolov7_d2_tpu/config/defaults.py``, copied whole so that every yaml under
``configs/`` merges into it. One value differs: ``MODEL.DEVICE`` is
``"cuda"`` (the port's entry points run on the card unless the config says
``MODEL.DEVICE cpu``). The ``TPU`` keys are read by nothing in the port.
"""

from __future__ import annotations

from yolov7_d2_tpu_torch.config.cfg_node import CfgNode


def get_cfg() -> CfgNode:
    _C = CfgNode()

    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.VIS_PERIOD = 0

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CfgNode()
    _C.MODEL.DEVICE = "cuda"  # the JAX package: "tpu"
    _C.MODEL.META_ARCHITECTURE = "YOLOX"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    # BGR order, raw-pixel scale — matches configs/Base-YOLOv7.yaml.
    _C.MODEL.PIXEL_MEAN = [103.53, 116.28, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    # 'normal' | 'softnms-linear' | 'softnms-gaussian' | 'cluster'
    _C.MODEL.NMS_TYPE = "normal"
    _C.MODEL.ONNX_EXPORT = False
    _C.MODEL.PADDED_VALUE = 114.0

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_cspdarknetx_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 0
    _C.MODEL.BACKBONE.SUBTYPE = "s"
    _C.MODEL.BACKBONE.PRETRAINED = False
    _C.MODEL.BACKBONE.WEIGHTS = ""
    _C.MODEL.BACKBONE.FEATURE_INDICES = [1, 4, 10, 15]
    _C.MODEL.BACKBONE.OUT_FEATURES = ["stride8", "stride16", "stride32"]
    _C.MODEL.BACKBONE.SIMPLE = False
    _C.MODEL.BACKBONE.STRIDE = 1

    # DLA / DLASeg (reference dla.py:430 build_dla_backbone cfg surface)
    _C.MODEL.DLA = CfgNode()
    _C.MODEL.DLA.NUM_LAYERS = 34
    _C.MODEL.DLA.OUT_FEATURES = ["dla2"]
    _C.MODEL.DLA.USE_DLA_UP = True
    _C.MODEL.DLA.MS_OUTPUT = False
    _C.MODEL.DLA.NORM = "BN"
    _C.MODEL.BACKBONE.CHANNEL = 0
    _C.MODEL.BACKBONE.ANTI_ALIAS = False

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.REPEAT = 2
    _C.MODEL.FPN.OUT_CHANNELS_LIST = [256, 512, 1024]
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    # GeneralizedRCNN family (the d2-substrate models of the LazyConfig
    # zoo: mask_rcnn_fpn.py / new_baselines — rebuilt natively)
    _C.MODEL.RPN = CfgNode()
    _C.MODEL.RPN.PRE_NMS_TOPK = 256     # per level, static
    _C.MODEL.RPN.POST_NMS_TOPK = 128    # fixed proposal count
    _C.MODEL.RPN.NMS_THRESH = 0.7
    # d2 RPN sampling (reference mask_rcnn_fpn.py:46-47)
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.ROI_HEADS = CfgNode()
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    # d2 ROI sampling (reference mask_rcnn_fpn.py:53-55);
    # SAMPLE_MODE "sampled" = d2 random fixed-size subsample,
    # "expectation" = dense weighted matching (its expectation)
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SAMPLE_MODE = "sampled"
    _C.MODEL.ROI_BOX_HEAD = CfgNode()
    # d2 default: per-class box regression
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.SEM_SEG_HEAD = CfgNode()
    _C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    _C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    _C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128

    _C.MODEL.BIFPN = CfgNode()
    _C.MODEL.BIFPN.NUM_LEVELS = 5
    _C.MODEL.BIFPN.NUM_BIFPN = 6
    _C.MODEL.BIFPN.NORM = "GN"
    _C.MODEL.BIFPN.OUT_CHANNELS = 160
    _C.MODEL.BIFPN.SEPARABLE_CONV = False

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1
    _C.MODEL.RESNETS.R2TYPE = "res2net50_v1d"
    # resnet-vd (deep stem + avgpool downsample), PP-YOLO flavour
    _C.MODEL.RESNETS.VD = False

    _C.MODEL.REGNETS = CfgNode()
    _C.MODEL.REGNETS.TYPE = "x"
    _C.MODEL.REGNETS.OUT_FEATURES = ["s2", "s3", "s4"]

    _C.MODEL.DARKNET = CfgNode()
    _C.MODEL.DARKNET.DEPTH = 53
    _C.MODEL.DARKNET.WITH_CSP = True
    _C.MODEL.DARKNET.RES5_DILATION = 1
    _C.MODEL.DARKNET.NORM = "BN"
    _C.MODEL.DARKNET.STEM_OUT_CHANNELS = 32
    _C.MODEL.DARKNET.OUT_FEATURES = ["dark3", "dark4", "dark5"]
    _C.MODEL.DARKNET.WEIGHTS = ""
    _C.MODEL.DARKNET.DEPTH_WISE = False

    _C.MODEL.SWIN = CfgNode()
    _C.MODEL.SWIN.TYPE = "tiny"
    _C.MODEL.SWIN.WEIGHTS = ""
    _C.MODEL.SWIN.PATCH = 4
    _C.MODEL.SWIN.WINDOW = 7
    _C.MODEL.SWIN.DEPTHS = [2, 2, 6, 2]
    _C.MODEL.SWIN.OUT_FEATURES = [1, 2, 3]

    _C.MODEL.PVT = CfgNode()
    _C.MODEL.PVT.TYPE = "b1"
    _C.MODEL.PVT.OUT_FEATURES = [1, 2, 3]

    _C.MODEL.CONVNEXT = CfgNode()
    _C.MODEL.CONVNEXT.TYPE = "tiny"
    _C.MODEL.CONVNEXT.DROP_PATH_RATE = 0.2
    _C.MODEL.CONVNEXT.LAYER_SCALE_INIT_VALUE = 1e-6
    _C.MODEL.CONVNEXT.OUT_FEATURES = [1, 2, 3]

    _C.MODEL.EFFICIENTNET = CfgNode()
    _C.MODEL.EFFICIENTNET.NAME = "efficientnet_b0"
    _C.MODEL.EFFICIENTNET.PRETRAINED = False
    _C.MODEL.EFFICIENTNET.FEATURE_INDICES = [1, 4, 10, 15]
    _C.MODEL.EFFICIENTNET.OUT_FEATURES = [
        "stride4", "stride8", "stride16", "stride32",
    ]

    # ------------------------------------------------------------------ YOLO
    _C.MODEL.YOLO = CfgNode()
    _C.MODEL.YOLO.NUM_BRANCH = 3
    _C.MODEL.YOLO.BRANCH_DILATIONS = [1, 2, 3]
    _C.MODEL.YOLO.TEST_BRANCH_IDX = 1
    _C.MODEL.YOLO.VARIANT = "yolov3"  # yolov3 | yolov5 | yolov7
    _C.MODEL.YOLO.ANCHORS = [
        [[116, 90], [156, 198], [373, 326]],
        [[30, 61], [62, 45], [42, 119]],
        [[10, 13], [16, 30], [33, 23]],
    ]
    _C.MODEL.YOLO.ANCHOR_MASK = []
    _C.MODEL.YOLO.CLASSES = 80
    _C.MODEL.YOLO.MAX_BOXES_NUM = 100
    _C.MODEL.YOLO.IN_FEATURES = ["dark3", "dark4", "dark5"]
    _C.MODEL.YOLO.CONF_THRESHOLD = 0.01
    _C.MODEL.YOLO.NMS_THRESHOLD = 0.5
    _C.MODEL.YOLO.IGNORE_THRESHOLD = 0.07
    _C.MODEL.YOLO.NORMALIZE_INPUT = False
    _C.MODEL.YOLO.WIDTH_MUL = 1.0
    _C.MODEL.YOLO.DEPTH_MUL = 1.0
    _C.MODEL.YOLO.IOU_TYPE = "ciou"  # iou | giou | diou | ciou | siou
    _C.MODEL.YOLO.LOSS_TYPE = "v4"
    _C.MODEL.YOLO.KEYPOINTS_NUM = 17  # wired (the reference leaves it undefined)
    _C.MODEL.YOLO.MAX_DETECTIONS = 100  # static NMS output size (TPU)
    _C.MODEL.YOLO.NMS_PRE_TOPK = 1024  # pre-NMS candidate cap (TPU)
    # SimOTA candidate prefilter (TPU static-shape cost-pipeline cap):
    # >0 exact value, 0 auto (max(1024, A//4), exact whenever the geometric
    # candidate set fits), <0 disable (full [G, A] pipeline, always exact)
    _C.MODEL.YOLO.SIMOTA_PREFILTER_TOPK = 0

    _C.MODEL.YOLO.LOSS = CfgNode()
    _C.MODEL.YOLO.LOSS.LAMBDA_XY = 1.0
    _C.MODEL.YOLO.LOSS.LAMBDA_WH = 1.0
    _C.MODEL.YOLO.LOSS.LAMBDA_CLS = 1.0
    _C.MODEL.YOLO.LOSS.LAMBDA_CONF = 1.0
    _C.MODEL.YOLO.LOSS.LAMBDA_IOU = 1.1
    _C.MODEL.YOLO.LOSS.USE_L1 = True
    _C.MODEL.YOLO.LOSS.ANCHOR_RATIO_THRESH = 4.0
    _C.MODEL.YOLO.LOSS.BUILD_TARGET_TYPE = "default"  # default | yolov5

    _C.MODEL.YOLO.NECK = CfgNode()
    _C.MODEL.YOLO.NECK.TYPE = "yolov3"  # yolov3 | fpn | pafpn | reppan
    _C.MODEL.YOLO.NECK.WITH_SPP = False

    _C.MODEL.YOLO.HEAD = CfgNode()
    _C.MODEL.YOLO.HEAD.TYPE = "yolox"

    _C.MODEL.YOLO.ORIEN_HEAD = CfgNode()
    _C.MODEL.YOLO.ORIEN_HEAD.UP_CHANNELS = 64

    # ---------------------------------------------------------------- SOLOV2
    _C.MODEL.SOLOV2 = CfgNode()
    _C.MODEL.SOLOV2.INSTANCE_IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    _C.MODEL.SOLOV2.FPN_INSTANCE_STRIDES = [8, 8, 16, 32, 32]
    _C.MODEL.SOLOV2.FPN_SCALE_RANGES = [
        [1, 96], [48, 192], [96, 384], [192, 768], [384, 2048],
    ]
    _C.MODEL.SOLOV2.SIGMA = 0.2
    _C.MODEL.SOLOV2.INSTANCE_IN_CHANNELS = 256
    _C.MODEL.SOLOV2.INSTANCE_CHANNELS = 512
    _C.MODEL.SOLOV2.NUM_INSTANCE_CONVS = 4
    _C.MODEL.SOLOV2.USE_DCN_IN_INSTANCE = False
    _C.MODEL.SOLOV2.TYPE_DCN = "DCN"
    _C.MODEL.SOLOV2.NUM_GRIDS = [40, 36, 24, 16, 12]
    _C.MODEL.SOLOV2.NUM_CLASSES = 80
    _C.MODEL.SOLOV2.NUM_KERNELS = 256
    _C.MODEL.SOLOV2.NORM = "GN"
    _C.MODEL.SOLOV2.USE_COORD_CONV = True
    _C.MODEL.SOLOV2.PRIOR_PROB = 0.01
    _C.MODEL.SOLOV2.MASK_IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.SOLOV2.MASK_IN_CHANNELS = 256
    _C.MODEL.SOLOV2.MASK_CHANNELS = 128
    _C.MODEL.SOLOV2.NUM_MASKS = 256
    _C.MODEL.SOLOV2.NMS_PRE = 500
    _C.MODEL.SOLOV2.SCORE_THR = 0.1
    _C.MODEL.SOLOV2.UPDATE_THR = 0.05
    _C.MODEL.SOLOV2.MASK_THR = 0.5
    _C.MODEL.SOLOV2.MAX_PER_IMG = 100
    _C.MODEL.SOLOV2.NMS_TYPE = "matrix"  # matrix | mask
    _C.MODEL.SOLOV2.NMS_KERNEL = "gaussian"  # gaussian | linear
    _C.MODEL.SOLOV2.NMS_SIGMA = 2.0
    _C.MODEL.SOLOV2.LOSS = CfgNode()
    _C.MODEL.SOLOV2.LOSS.FOCAL_USE_SIGMOID = True
    _C.MODEL.SOLOV2.LOSS.FOCAL_ALPHA = 0.25
    _C.MODEL.SOLOV2.LOSS.FOCAL_GAMMA = 2.0
    _C.MODEL.SOLOV2.LOSS.FOCAL_WEIGHT = 1.0
    _C.MODEL.SOLOV2.LOSS.DICE_WEIGHT = 3.0

    # ------------------------------------------------------------ SPARSE_INST
    _C.MODEL.SPARSE_INST = CfgNode()
    _C.MODEL.SPARSE_INST.CLS_THRESHOLD = 0.005
    _C.MODEL.SPARSE_INST.MASK_THRESHOLD = 0.45
    _C.MODEL.SPARSE_INST.MAX_DETECTIONS = 100
    _C.MODEL.SPARSE_INST.DATASET_MAPPER = "SparseInstDatasetMapper"
    _C.MODEL.SPARSE_INST.ENCODER = CfgNode()
    _C.MODEL.SPARSE_INST.ENCODER.NAME = "FPNPPMEncoder"
    _C.MODEL.SPARSE_INST.ENCODER.NORM = ""
    _C.MODEL.SPARSE_INST.ENCODER.IN_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.SPARSE_INST.ENCODER.NUM_CHANNELS = 256
    _C.MODEL.SPARSE_INST.DECODER = CfgNode()
    _C.MODEL.SPARSE_INST.DECODER.NAME = "BaseIAMDecoder"
    _C.MODEL.SPARSE_INST.DECODER.NUM_MASKS = 100
    _C.MODEL.SPARSE_INST.DECODER.NUM_CLASSES = 80
    _C.MODEL.SPARSE_INST.DECODER.KERNEL_DIM = 128
    _C.MODEL.SPARSE_INST.DECODER.SCALE_FACTOR = 2.0
    _C.MODEL.SPARSE_INST.DECODER.OUTPUT_IAM = False
    _C.MODEL.SPARSE_INST.DECODER.GROUPS = 4
    _C.MODEL.SPARSE_INST.DECODER.INST = CfgNode()
    _C.MODEL.SPARSE_INST.DECODER.INST.DIM = 256
    _C.MODEL.SPARSE_INST.DECODER.INST.CONVS = 4
    _C.MODEL.SPARSE_INST.DECODER.MASK = CfgNode()
    _C.MODEL.SPARSE_INST.DECODER.MASK.DIM = 256
    _C.MODEL.SPARSE_INST.DECODER.MASK.CONVS = 4
    _C.MODEL.SPARSE_INST.LOSS = CfgNode()
    _C.MODEL.SPARSE_INST.LOSS.NAME = "SparseInstCriterion"
    _C.MODEL.SPARSE_INST.LOSS.ITEMS = ["labels", "masks"]
    _C.MODEL.SPARSE_INST.LOSS.CLASS_WEIGHT = 2.0
    _C.MODEL.SPARSE_INST.LOSS.MASK_PIXEL_WEIGHT = 5.0
    _C.MODEL.SPARSE_INST.LOSS.MASK_DICE_WEIGHT = 2.0
    _C.MODEL.SPARSE_INST.LOSS.OBJECTNESS_WEIGHT = 1.0
    _C.MODEL.SPARSE_INST.MATCHER = CfgNode()
    _C.MODEL.SPARSE_INST.MATCHER.NAME = "SparseInstMatcher"
    _C.MODEL.SPARSE_INST.MATCHER.ALPHA = 0.8
    _C.MODEL.SPARSE_INST.MATCHER.BETA = 0.2

    # ------------------------------------------------------------------ DETR
    _C.MODEL.DETR = CfgNode()
    _C.MODEL.DETR.NUM_CLASSES = 80
    _C.MODEL.DETR.FROZEN_WEIGHTS = ""
    _C.MODEL.DETR.DEFORMABLE = False
    _C.MODEL.DETR.USE_FOCAL_LOSS = False
    _C.MODEL.DETR.CENTERED_POSITION_ENCODIND = False
    _C.MODEL.DETR.CLS_WEIGHT = 1.0
    _C.MODEL.DETR.GIOU_WEIGHT = 2.0
    _C.MODEL.DETR.L1_WEIGHT = 5.0
    _C.MODEL.DETR.DEEP_SUPERVISION = True
    _C.MODEL.DETR.NO_OBJECT_WEIGHT = 0.1
    # rematerialize transformer layers in the backward pass (activation
    # memory vs recompute — the batch-scaling lever, docs/PERF.md)
    _C.MODEL.DETR.REMAT = False
    _C.MODEL.DETR.WITH_BOX_REFINE = False
    _C.MODEL.DETR.TWO_STAGE = False
    _C.MODEL.DETR.DECODER_BLOCK_GRAD = True
    _C.MODEL.DETR.ATTENTION_TYPE = "DETR"  # DETR | SMCA | RCDA
    _C.MODEL.DETR.NHEADS = 8
    _C.MODEL.DETR.DROPOUT = 0.1
    _C.MODEL.DETR.DIM_FEEDFORWARD = 2048
    _C.MODEL.DETR.ENC_LAYERS = 6
    _C.MODEL.DETR.DEC_LAYERS = 6
    _C.MODEL.DETR.PRE_NORM = False
    _C.MODEL.DETR.BBOX_EMBED_NUM_LAYERS = 3
    _C.MODEL.DETR.HIDDEN_DIM = 256
    _C.MODEL.DETR.NUM_OBJECT_QUERIES = 100
    _C.MODEL.DETR.NUM_FEATURE_LEVELS = 1
    _C.MODEL.DETR.NUM_QUERY_POSITION = 300
    _C.MODEL.DETR.NUM_QUERY_PATTERN = 3
    _C.MODEL.DETR.SPATIAL_PRIOR = "learned"

    _C.MODEL.FBNET_V2 = CfgNode()
    _C.MODEL.FBNET_V2.ARCH = "default"
    # literal arch-def dicts (reference fbnet_v2.py:64-71): a list of dicts
    # merged in order; the merged dict's "trunk" is the mobile_cv-format
    # stage table (op vocabulary: conv_k{1,3,5}, ir_k{3,5}, skip, ir_pool
    # with _se/_hs modifiers; negative stride = upsample)
    _C.MODEL.FBNET_V2.ARCH_DEF = []
    _C.MODEL.FBNET_V2.OUT_FEATURES = ["trunk3"]
    _C.MODEL.FBNET_V2.WIDTH_DIVISOR = 8
    _C.MODEL.FBNET_V2.SCALE_FACTOR = 1.0

    # ---------------------------------------------------------------- INPUT
    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = [640]
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 640
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"
    _C.INPUT.INPUT_SIZE = [640, 640]  # (h, w)
    _C.INPUT.CROP = CfgNode()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]

    _C.INPUT.MOSAIC = CfgNode()
    _C.INPUT.MOSAIC.ENABLED = False
    _C.INPUT.MOSAIC.DEBUG_VIS = False
    _C.INPUT.MOSAIC.POOL_CAPACITY = 1000
    _C.INPUT.MOSAIC.NUM_IMAGES = 4
    _C.INPUT.MOSAIC.MIN_OFFSET = 0.2
    _C.INPUT.MOSAIC.MOSAIC_WIDTH = 640
    _C.INPUT.MOSAIC.MOSAIC_HEIGHT = 640

    _C.INPUT.MOSAIC_AND_MIXUP = CfgNode()
    _C.INPUT.MOSAIC_AND_MIXUP.ENABLED = False
    # run mosaic/mixup/HSV/flip ON DEVICE inside the jitted train step
    # (data/device_aug.py); host workers then only decode + resize tiles
    _C.INPUT.MOSAIC_AND_MIXUP.DEVICE = False
    _C.INPUT.MOSAIC_AND_MIXUP.DEBUG_VIS = False
    _C.INPUT.MOSAIC_AND_MIXUP.POOL_CAPACITY = 1000
    _C.INPUT.MOSAIC_AND_MIXUP.NUM_IMAGES = 4
    _C.INPUT.MOSAIC_AND_MIXUP.DEGREES = 10.0
    _C.INPUT.MOSAIC_AND_MIXUP.TRANSLATE = 0.1
    _C.INPUT.MOSAIC_AND_MIXUP.SCALE = [0.5, 1.5]
    _C.INPUT.MOSAIC_AND_MIXUP.MSCALE = [0.5, 1.5]
    _C.INPUT.MOSAIC_AND_MIXUP.SHEAR = 2.0
    _C.INPUT.MOSAIC_AND_MIXUP.PERSPECTIVE = 0.0
    _C.INPUT.MOSAIC_AND_MIXUP.ENABLE_MIXUP = True
    _C.INPUT.MOSAIC_AND_MIXUP.MOSAIC_WIDTH_RANGE = [512, 800]
    _C.INPUT.MOSAIC_AND_MIXUP.MOSAIC_HEIGHT_RANGE = [512, 800]
    _C.INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER = 120000

    _C.INPUT.RANDOM_FLIP_HORIZONTAL = CfgNode()
    _C.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED = True
    _C.INPUT.RANDOM_FLIP_HORIZONTAL.PROB = 0.5
    _C.INPUT.RANDOM_FLIP_VERTICAL = CfgNode()
    _C.INPUT.RANDOM_FLIP_VERTICAL.ENABLED = False
    _C.INPUT.RANDOM_FLIP_VERTICAL.PROB = 0.5

    _C.INPUT.SHIFT = CfgNode()
    _C.INPUT.SHIFT.ENABLED = False
    _C.INPUT.SHIFT.SHIFT_PIXELS = 32

    _C.INPUT.COLOR_JITTER = CfgNode()
    _C.INPUT.COLOR_JITTER.BRIGHTNESS = False
    _C.INPUT.COLOR_JITTER.SATURATION = False
    _C.INPUT.COLOR_JITTER.LIGHTING = False

    _C.INPUT.DISTORTION = CfgNode()
    _C.INPUT.DISTORTION.ENABLED = False
    _C.INPUT.DISTORTION.HUE = 0.1
    _C.INPUT.DISTORTION.SATURATION = 1.5
    _C.INPUT.DISTORTION.EXPOSURE = 1.5

    _C.INPUT.RESIZE = CfgNode()
    _C.INPUT.RESIZE.ENABLED = False
    _C.INPUT.RESIZE.SHAPE = [640, 640]
    _C.INPUT.RESIZE.SCALE_JITTER = [0.8, 1.2]
    _C.INPUT.RESIZE.TEST_SHAPE = [608, 608]

    _C.INPUT.JITTER_CROP = CfgNode()
    _C.INPUT.JITTER_CROP.ENABLED = False
    _C.INPUT.JITTER_CROP.JITTER_RATIO = 0.3

    _C.INPUT.GRID_MASK = CfgNode()
    _C.INPUT.GRID_MASK.ENABLED = False
    _C.INPUT.GRID_MASK.MODE = 1
    _C.INPUT.GRID_MASK.PROB = 0.3
    _C.INPUT.GRID_MASK.USE_HEIGHT = True
    _C.INPUT.GRID_MASK.USE_WIDTH = True

    # -------------------------------------------------------------- DATASETS
    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ["coco_2017_train"]
    _C.DATASETS.TEST = ["coco_2017_val"]
    _C.DATASETS.CLASS_NAMES = []

    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 4
    # pre-augmented packed-shard cache dir (data/packed_cache.py): when
    # set, train_det reads uint8 shards (offline geometry) and runs the
    # DEVICE photometric aug (mixup blend + HSV + flip) fused in the
    # jitted train step — the measured feed-the-chip recipe for weak
    # hosts (docs/PERF.md round 4)
    _C.DATALOADER.PACKED_CACHE_DIR = ""
    # plain (un-augmented) shard set for the reference's DISABLE_AT_ITER
    # final phase (dataset_mapper.py:400,490): the loader switches to it
    # at the disable iteration (data/packed_cache.py
    # SwitchingPackedLoader; write with write_plain_shards). When empty,
    # mosaic-baked shards keep feeding after the disable iter (only the
    # device photometrics stop) — a documented deviation train_det warns
    # about.
    _C.DATALOADER.PACKED_CACHE_PLAIN_DIR = ""
    _C.DATALOADER.PREFETCH_BUFFER = 2
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
    _C.DATALOADER.SHUFFLE = True

    # ---------------------------------------------------------------- SOLVER
    _C.SOLVER = CfgNode()
    _C.SOLVER.OPTIMIZER = "sgd"  # sgd | adamw
    # keep adam first-moment state in bf16 (halves optimizer HBM; optax
    # mu_dtype — nu stays f32 for scale stability)
    _C.SOLVER.ADAM_BF16_STATE = False
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.BASE_LR = 0.01
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = True
    _C.SOLVER.WEIGHT_DECAY = 5e-4
    # d2 semantics (detectron2 solver/build.py, driven by the reference's
    # optimizer/build.py:120-171): None means "same as WEIGHT_DECAY".
    # d2's defaults are NORM=0.0, BIAS=None — the reference trainers DO
    # decay conv/dense biases at the base weight decay.
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    _C.SOLVER.WEIGHT_DECAY_EMBED = 0.0
    # per-group LR: bias factor (d2) + module-name multipliers (d2go,
    # reference build.py:78-117, e.g. [{'backbone': 0.1}]).
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.LR_MULTIPLIER_OVERWRITE = []
    _C.SOLVER.BACKBONE_MULTIPLIER = 1.0
    _C.SOLVER.AMSGRAD = False
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = [60000, 80000]
    _C.SOLVER.MAX_ITER = 90000
    _C.SOLVER.WARMUP_FACTOR = 0.001
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.LR_SCHEDULER = CfgNode()
    _C.SOLVER.LR_SCHEDULER.NAME = "WarmupMultiStepLR"
    _C.SOLVER.LR_SCHEDULER.MAX_ITER = 40000
    _C.SOLVER.LR_SCHEDULER.MAX_EPOCH = 500
    _C.SOLVER.LR_SCHEDULER.STEPS = [30000]
    _C.SOLVER.LR_SCHEDULER.WARMUP_FACTOR = 0.001
    _C.SOLVER.LR_SCHEDULER.WARMUP_ITERS = 1000
    _C.SOLVER.LR_SCHEDULER.WARMUP_METHOD = "linear"
    _C.SOLVER.LR_SCHEDULER.GAMMA = 0.1
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CfgNode()
    _C.SOLVER.AMP.ENABLED = True  # maps to bf16 compute on TPU
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.EMA = CfgNode()
    _C.SOLVER.EMA.ENABLED = False
    _C.SOLVER.EMA.DECAY = 0.9998

    # ------------------------------------------------------------------ TEST
    _C.TEST = CfgNode()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CfgNode()
    _C.TEST.AUG.ENABLED = False

    # ------------------------------------------------------------------- TPU
    # TPU-native knobs (replaces the reference's CUDA/NCCL/AMP surface).
    _C.TPU = CfgNode()
    _C.TPU.MESH_SHAPE = [-1, 1]  # (data, model); -1 = all remaining devices
    _C.TPU.MESH_AXES = ["data", "model"]
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.REMAT = False  # jax.checkpoint the backbone to trade FLOPs for HBM
    _C.TPU.DONATE_STATE = True

    # ----------------------------------------------------------------- WANDB
    _C.WANDB = CfgNode()
    _C.WANDB.ENABLED = False
    _C.WANDB.PROJECT_NAME = "yolov7_d2_tpu"

    return _C


def add_yolo_config(cfg: CfgNode) -> CfgNode:
    """Parity alias with the reference API (yolov7/config.py:11).

    Our :func:`get_cfg` already contains every key; this is a no-op merge
    point kept so reference-style call sites keep working.
    """
    return cfg

