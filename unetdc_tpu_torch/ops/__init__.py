"""Device image-analysis ops of the port (the JAX package's `ops`
surface): the names its `ops/__init__.py` exports, from the port's
modules. The CUDA kernels behind K1-K3 are `fused_conv` and
`component_tables`."""

from unetdc_tpu_torch.ops.connected_components import (  # noqa: F401
    label,
    label_batch,
    propagate_roots,
    quantify_mask,
    quantify_mask_adaptive,
    quantify_mask_batch,
    remove_small_batch,
    remove_small_batch_counted,
    sieve_small_components,
)
from unetdc_tpu_torch.ops.regionprops import (  # noqa: F401
    regionprops_table,
    centroid_size_image,
)
from unetdc_tpu_torch.ops.density import (  # noqa: F401
    density_map,
    density_maps,
    get_target,
    get_targets,
    gaussian_density_map,
    radial_centroid_count_map,
)
from unetdc_tpu_torch.ops.contours import (  # noqa: F401
    contour_scan,
    contour_spreading_4,
    contour_spreading_8,
    contour_shrinking_box,
    remove_objects,
    calculate_contours_centroid,
)
from unetdc_tpu_torch.ops.roi import (  # noqa: F401
    generate_roi_mask,
    moments_centroid,
    rgb2gray_cv2,
)
from unetdc_tpu_torch.ops.edt import (  # noqa: F401
    distance_transform_edt,
    distance_transform_edt_sq,
    peak_local_max_device,
    watershed_device,
)
from unetdc_tpu_torch.ops.diffmap import (  # noqa: F401
    create_difference_map,
    overlay_difference,
    count_color_regions,
)
from unetdc_tpu_torch.ops.resize import (  # noqa: F401
    resize_linear,
    resize_nearest,
    resize_area,
    resize_mask_linear_round,
)
from unetdc_tpu_torch.ops.morphology import (  # noqa: F401
    ellipse_kernel,
    erode,
    dilate,
    morph_open,
    morph_close,
)
from unetdc_tpu_torch.ops.rolling_ball import (  # noqa: F401
    rolling_ball_correction_rgb)
from unetdc_tpu_torch.ops.threshold import otsu_threshold  # noqa: F401
from unetdc_tpu_torch.ops.filters import (  # noqa: F401
    gaussian_blur, gaussian_filter_scipy)
