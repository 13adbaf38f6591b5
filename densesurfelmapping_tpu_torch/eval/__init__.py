from .fidelity import (render_depth, depth_metrics, evaluate_map,
                       backproject_cloud, cloud_metrics, evaluate_map_clouds,
                       densify_surfels)
