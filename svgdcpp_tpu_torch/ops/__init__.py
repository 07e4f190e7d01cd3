from .pairwise import squared_pairwise_distances, weighted_quadratic_pairwise
from .median import (
    median_exact,
    pairwise_distance_median,
    pairwise_distance_median_exact,
    kth_smallest_bisect,
    count_le_cross,
    pairwise_distance_median_bisect,
    pairwise_distance_median_histogram,
)
from .phi import (
    phi_generic,
    phi_generic_cross,
    phi_rbf,
    phi_rbf_blocked,
    phi_rbf_cross,
    phi_rbf_fused_counts,
    phi_rbf_terms,
    phi_rbf_terms_cross,
    phi_rbf_terms_fused_counts,
    rbf_kernel_matrix,
)
from .cuda_phi import (
    phi_rbf_fused_cuda,
    phi_rbf_fused_cuda_cross,
    phi_rbf_terms_fused_cuda,
    phi_rbf_terms_fused_cuda_cross,
)
